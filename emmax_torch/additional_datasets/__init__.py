"""Extra instruct sets for VLM pretraining (LRV-Instruct,
LVIS-Instruct-4V), ports of ``scripts/additional-datasets/*.py``."""
