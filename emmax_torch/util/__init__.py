"""Host-side utilities: split-modality batching."""
