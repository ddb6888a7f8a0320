"""Raster pipeline of the PyTorch port: vertex stage, setup and binning,
the plain tile raster, fragment shaders, the CUDA kernels and the
end-to-end entries (see pipeline.py)."""
