"""Host-side front end of the port: the voxel-GP map and the synthetic
frame source (own copies of gslivm_tpu/frontend/{gpmap,synthetic}.py)."""
