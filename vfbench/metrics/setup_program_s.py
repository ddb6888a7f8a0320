"""setup_program_s: host seconds of the program's set-up spans closed before
the first traced call (``vf.setup.load``, ``vf.Renderer.add_terrain``,
``vf.Renderer.upload_height_r32f``, ``vf.mesh``): the part of ``setup_s``
the program spends."""

from ..program import setup_s


def read(reading):
    return setup_s()
