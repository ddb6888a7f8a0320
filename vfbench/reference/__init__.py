"""The plain reference of the benchmark: frames worked out again from the
benchmark's inputs in plain PyTorch and numpy. It imports nothing of the
program (``vulkan_forge_torch``), of its JAX original or of JAX."""
