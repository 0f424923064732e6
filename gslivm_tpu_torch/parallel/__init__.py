"""The multi-device train step on torch.distributed: a ("gauss", "pixel")
mesh, the gathered-parameter renderers and the depth-slab renderer
(port of gslivm_tpu/parallel/)."""
