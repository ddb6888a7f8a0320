"""Raster pipeline of the PyTorch port: vertex stage, setup and binning,
the plain tile raster, the vertex-stream route for dense grids (vtx.py),
fragment shaders, the CUDA kernels and the end-to-end entries (see
pipeline.py)."""
