"""PyTorch + CUDA port of sparseeventid_tpu: the sparse-ResNet event
classifier, with the window engine's TPU kernels rewritten as CUDA kernels
for Hopper (``csrc/``).  It imports nothing of the JAX package."""
