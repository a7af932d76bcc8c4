"""GCOT dataset generation, port of ``emmax_tpu/gcot``: trajectory
segmentation (the port's own HDBSCAN, ``gcot/hdbscan.py``), movement
verbalization, plan annotation and dataset assembly. Host code: numpy,
scipy and the standard library."""
