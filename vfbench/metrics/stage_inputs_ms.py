"""stage_inputs_ms: stream ms per call in the program's ``vf.inputs`` spans:
validation, camera, LUT, the mesh's build or upload and the parameters'
uploads, before the first vertex-stage op."""

from ..program import stage_ms


def read(reading):
    return stage_ms("vf.inputs")
