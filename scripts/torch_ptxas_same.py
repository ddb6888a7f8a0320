#!/usr/bin/env python3
"""Whether the CUDA raster library of this checkout compiles to what
another checkout's does: ptxas's report per kernel (registers, shared
memory, stack, spills, barriers; its compile times left out) and the SASS
that ``cuobjdump -sass`` prints (its file identifiers left out), with the
name nvcc gives each source's anonymous namespace (``_GLOBAL__N__<hash>_``,
a hash of the source file) written as one token. A change to comments
alone must leave both equal.

Usage, from the root of a checkout, on a machine with nvcc and cuobjdump:

    python3 scripts/torch_ptxas_same.py OTHER_ROOT

Builds both checkouts' libraries (``vulkan_forge_torch._raster.kernels.build``),
one process per checkout, started together; prints one JSON line with
both libraries, the entries ptxas compiled, and whether the reports and
the SASS are equal, with the first differing lines; exits 1 if either
differs.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD = "from vulkan_forge_torch._raster import kernels; print(kernels.build())"
ANON = re.compile(r"_GLOBAL__N__[0-9a-f]+_")


def normal(lines):
    return [ANON.sub("_GLOBAL__N__", ln) for ln in lines]


def cuobjdump() -> str:
    found = shutil.which("cuobjdump")
    if found:
        return found
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")


def first_diff(a, b):
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return {"line": i, "this": y, "other": x}
    return None if len(a) == len(b) else {"lines": [len(a), len(b)]}


def main() -> int:
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    roots = {"other": os.path.abspath(sys.argv[1]), "this": HERE}
    procs = {k: subprocess.Popen([sys.executable, "-c", BUILD], cwd=root, text=True,
                                 env=dict(os.environ, PYTHONPATH=root),
                                 stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for k, root in roots.items()}
    libs, ptxas, sass = {}, {}, {}
    for k, p in procs.items():
        out, err = p.communicate()
        if p.returncode != 0:
            raise SystemExit(f"the build of {roots[k]} failed:\n{out}\n{err}")
        libs[k] = out.strip().splitlines()[-1]
        ptxas[k] = normal(ln for ln in open(libs[k] + ".log").read().splitlines()
                          if "Compile time" not in ln)
        dump = subprocess.run([cuobjdump(), "-sass", libs[k]], check=True,
                              capture_output=True, text=True).stdout
        sass[k] = normal(ln for ln in dump.splitlines() if "identifier" not in ln)
    entries = [ln.split("'")[1] for ln in ptxas["this"] if "Compiling entry function" in ln]
    result = {"this": os.path.relpath(libs["this"], HERE),
              "other": os.path.relpath(libs["other"], HERE), "entries": len(entries),
              "ptxas_lines": len(ptxas["this"]), "sass_lines": len(sass["this"]),
              "ptxas_equal": ptxas["this"] == ptxas["other"],
              "sass_equal": sass["this"] == sass["other"],
              "ptxas_first_diff": first_diff(ptxas["other"], ptxas["this"]),
              "sass_first_diff": first_diff(sass["other"], sass["this"])}
    print(json.dumps(result))
    return 0 if result["ptxas_equal"] and result["sass_equal"] else 1


if __name__ == "__main__":
    sys.exit(main())
