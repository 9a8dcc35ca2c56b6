"""Host-side data: image folders, the training batcher, the native
crop/resize/flip (and JPEG decode) library."""
