"""Training data: the GCOT dataset, collators and device prefetch."""
