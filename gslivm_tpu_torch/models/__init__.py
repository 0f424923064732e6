"""models of the PyTorch port (mirrors gslivm_tpu/models)."""
