"""A frozen copy of the port's Voxel R-CNN path (detection/: the voxel trunk,
the anchor head, proposals, the RoI sampler and head, the losses, the train
step), every hand-written kernel replaced by its plain version: the plain
reference of the voxelrcnn cells (reference/voxelrcnn.py)."""
