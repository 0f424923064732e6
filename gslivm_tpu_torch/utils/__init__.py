"""utils of the PyTorch port (mirrors gslivm_tpu/utils)."""
