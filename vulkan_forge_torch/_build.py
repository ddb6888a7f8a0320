"""The port's native seam: how its three libraries are built, loaded and
bound, and how their kernels launch.

Each library module keeps what is its own: its sources, compiler and flags,
its table of C signatures and the constants it checks once loaded.
``_raster/kernels.py`` holds the CUDA raster kernels (``libvf_raster_*.so``),
``lab/_kernels.py`` the lab's kernels (``libvf_lab_*.so``) and ``_native.py``
the host core (``libvf_host_*.so``).

A library is compiled on first use into ``build/vulkan_forge_torch/`` at the
root of the checkout, named by a hash of its sources, headers and flags, so
that a library built otherwise is never loaded. Several processes may build
at once: each compiles in a directory of its own and renames the result
into place. It is loaded with ctypes, each function of its table typed.

Every kernel launches through ``launch``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "vulkan_forge_torch"


def nvcc() -> str:
    """The CUDA compiler: on the PATH, else under CUDA_HOME (/usr/local/cuda)."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on first "
                           "use and need the CUDA toolkit")
    return path


def library_path(name: str, files, flags) -> Path:
    """``BUILD_DIR/libvf_<name>_<hash>.so``: the hash of the files and flags."""
    h = hashlib.sha256()
    for f in files:
        h.update(Path(f).read_bytes())
    h.update(" ".join(flags).encode())
    return BUILD_DIR / f"libvf_{name}_{h.hexdigest()[:16]}.so"


def _run(cmds, what, timeout=None) -> str:
    """Start the commands together and wait for each (at most ``timeout``
    s); raise with the output of those that failed (each named ``what``, or
    by its command line), else return the output of all."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for cmd in cmds]
    logs, failed = [], []
    for p in procs:
        try:
            out, err = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            p.communicate()
            raise
        logs.append(out + err)
        if p.returncode != 0:
            failed.append(f"{what or ' '.join(p.args)} failed ({p.returncode}):\n{out}\n{err}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return "".join(logs)


def build(out: Path, sources, flags, cxx=None, what: str = "") -> Path:
    """Compile ``sources`` into the library ``out`` unless it is built.

    With ``nvcc`` (``cxx`` None), several sources compile each in its own
    process, all started together, and are then linked; one source compiles
    and links in one. The compiler's report (``-Xptxas -v``: registers,
    shared memory, spills) is kept as ``<library>.log``. With the host's
    C++ compiler ``cxx``, the one source builds in at most 300 s, and a
    compiler that does not run raises with ``what`` in the message.
    """
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cc = cxx or nvcc()
    tmp = tempfile.mkdtemp(dir=BUILD_DIR)
    try:
        lib = os.path.join(tmp, out.name)
        if cxx:
            cmd = [cc, *flags, "-o", lib, str(sources[0])]
            try:
                _run([cmd], None, timeout=300)
            except (OSError, subprocess.TimeoutExpired) as e:
                raise RuntimeError(f"{what} is built with a C++ compiler on first use, and "
                                   f"{' '.join(cmd)} did not run: {e}") from e
        elif len(sources) == 1:
            log = _run([[cc, *flags, "-shared", "-o", lib, str(sources[0])]], "nvcc")
        else:
            objs = [os.path.join(tmp, src.stem + ".o") for src in sources]
            log = _run([[cc, *flags, "-c", "-o", obj, str(src)]
                        for src, obj in zip(sources, objs)], "nvcc")
            _run([[cc, "-shared", "-o", lib, *objs]], "nvcc link")
        if not cxx:
            Path(f"{out}.log").write_text(log)
        os.replace(lib, out)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def bind(lib, signatures: dict, restype=ctypes.c_int):
    """Type every function of ``signatures`` ({name: argtypes}) in ``lib``;
    returns ``lib``."""
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def load(path: Path, signatures: dict, what: str, contract=(), restype=ctypes.c_int):
    """The library at ``path``, bound to ``signatures`` and held to
    ``contract``: rows of (C getter, its source under csrc/, the Python
    constant it must equal, that constant's value). A failed load or a
    constant the two disagree on raises ``RuntimeError``."""
    try:
        lib = bind(ctypes.CDLL(str(path)), signatures, restype)
    except (OSError, AttributeError) as e:
        raise RuntimeError(f"could not load {what} {path}: {e}") from e
    for getter, source, name, want in contract:
        have = getattr(lib, getter)()
        if have != want:
            raise RuntimeError(f"csrc/{source} has {getter}() = {have} but {name} is {want}")
    return lib


# torch's own C calls for the current device and a device's current stream
# (a raw handle), as its compiled kernels' launchers take them. A CPU-only
# torch has neither, and launches nothing.
_current_device = getattr(torch._C, "_cuda_getDevice", None)
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def launch(wrapper, fn, t: torch.Tensor, *args, prepare=None) -> None:
    """Call the library function ``fn`` with args and the current stream of
    t's device, a CUDA tensor's, on that device (entered only if it is not
    the current one); ``prepare(index)``, if given, first. Raise on a
    nonzero CUDA error, else count the launch on ``wrapper.launches``."""
    index = t.get_device()
    if _current_device() == index:
        err = (prepare and prepare(index)) or fn(*args, _raw_stream(index))
    else:
        with torch.cuda.device(index):
            err = (prepare and prepare(index)) or fn(*args, _raw_stream(index))
    if err != 0:
        raise RuntimeError(f"{fn.__name__} launch failed with CUDA error {err}")
    wrapper.launches += 1
