"""The reference's five examples (``python/examples/*.py``) as twins on torch.

Run each as ``python -m vulkan_forge_torch.examples.<name>``: ``triangle``,
``two_triangles``, ``terrain``, ``add_terrain``, ``terrain_normals_flip``.
Each does what its original does at the original's sizes and prints the
original's lines; it takes ``--device`` (default ``cuda``: without a card it
fails) and writes its PNGs into the working directory under ``_torch`` names,
so that it never overwrites an original's.
"""
