"""Where the port's compiled libraries go: ``build/vulkan_forge_torch/`` at
the root of the checkout, beside the package. Each library is named by a
hash of its sources and flags (``_raster/kernels.py`` for the CUDA kernels,
``_native.py`` for the host core)."""
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "vulkan_forge_torch"
