"""Build, load and count the hand-written CUDA kernels in `csrc/`.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled with
`nvcc` into its own shared library at first use (no PyTorch headers, so
a build takes seconds), then loaded with `ctypes`. Libraries land in the
build directory (`build/kernels/` beside the package, or
`$TRLX_TPU_TORCH_BUILD_DIR`), named by a hash of the source and the
shared headers (`csrc/*.cuh`), so an edited source is rebuilt and a stale
library is never loaded.

`LAUNCHES` counts launches per kernel: each wrapper adds one where it
launches its kernel and nowhere else, so a run can show that its main
path went through the kernels (`reset_launches()` before, read after).
The count is taken under a lock: the replicas of a thread fleet launch
from their own scheduler threads at the same time as the trainer.

Nothing here runs at import: this module imports on machines without a
card or a CUDA toolkit, where only the plain versions of the kernels run.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

# kernel name -> launches since the last reset_launches()
LAUNCHES: Dict[str, int] = {}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
_count_lock = threading.Lock()


def reset_launches() -> None:
    with _count_lock:
        for name in list(LAUNCHES):
            LAUNCHES[name] = 0


def count_launch(name: str) -> None:
    with _count_lock:
        LAUNCHES[name] = LAUNCHES.get(name, 0) + 1


def build_dir() -> Path:
    env = os.environ.get("TRLX_TPU_TORCH_BUILD_DIR")
    return Path(env) if env else CSRC.parent.parent / "build" / "kernels"


def nvcc_path() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and Path("/usr/local/cuda/bin/nvcc").exists():
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels are built from csrc/ at first "
            "use and need the CUDA toolkit"
        )
    return nvcc


def library_path(name: str) -> Path:
    text = (CSRC / f"{name}.cu").read_bytes()
    text += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return build_dir() / f"lib{name}-{digest}.so"


def _start_build(name: str):
    """Launch nvcc for one source unless its library is already built.
    Returns (process or None, target path, temp path)."""
    target = library_path(name)
    if target.exists():
        return None, target, None
    target.parent.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, target, tmp


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile every named source at once (one nvcc each, all started
    together). Returns {name: compiler output} for the sources built now;
    raises on the first failed build."""
    started = [(name, *_start_build(name)) for name in names]
    logs = {}
    for name, proc, target, tmp in started:
        if proc is None:
            continue
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{out}")
        os.replace(tmp, target)  # atomic: concurrent builders never see half a file
        logs[name] = out
    return logs


def all_sources() -> List[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _libs[name] = lib
        return lib
