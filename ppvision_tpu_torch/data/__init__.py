"""Host-side data: image folders, the training batcher, the native
crop/resize/flip (and JPEG decode) library, optical flow, and the
captioner's Karpathy-split preprocessing and HDF5 dataset."""
