"""Hand-written CUDA kernels of the port, each beside its plain version:
stem_conv.py (the I3D stem), window_conv.py (the x-window sparse conv and
its shifted-table form), subm_conv.py (the index-map sparse conv and the
sparse convs' autograd), sparse_wgrad.py (their weight gradient),
row_gather.py (the row gather), neighbour_gather.py (the grid pool's
gather, whose backward is the kernel) and nms_bev.py (the rotated-BEV NMS's
suppression words and greedy sweep)."""
