"""Build the port's CUDA kernels at first use and bind them with ctypes.

Each `csrc/<name>.cu` compiles, on its own `nvcc` process (all started
together), into `build/repro_torch_kernels/<hash>/lib<name>.so` at the
repo root, where <hash> covers every file under csrc/ — an edited source
never loads a stale library. The sources have a plain C interface, so
no PyTorch header is compiled and the build takes seconds. Importing a
kernel module builds nothing; the first CUDA launch calls `function()`.

The flags target Hopper only (sm_90a); a missing `nvcc` or a failed
build raises — there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().with_name("csrc")
REPO = Path(__file__).resolve().parents[3]
BUILD_ROOT = REPO / "build" / "repro_torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
#: source name -> (C entry point, argtypes); the last argument is the stream.
SIGNATURES = {
    "bitonic_sort": ("rt_bitonic_sort",
                     [_P] * 5 + [_LL, _LL, _LL, _P, _I, _P]),
    "range_partition": ("rt_partition_offsets",
                        [_P] * 5 + [_LL, _LL, _I, _I, _P]),
    "merge_sorted": ("rt_merge_pairs", [_P] * 6 + [_LL, _LL, _P]),
    "kway_merge": ("rt_merge_pairs_indexed", [_P] * 9 + [_LL, _LL, _P]),
}

_lock = threading.Lock()
_count_lock = threading.Lock()
_fns: dict[str, ctypes._CFuncPtr] = {}
#: Devices whose capability was checked to be (9, 0) or newer.
_hopper: set = set()
#: Filled by the build: seconds, output directory, ptxas report per source.
build_info: dict = {}


def source_hash() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    found = cand if os.path.exists(cand) else shutil.which("nvcc")
    if not found:
        raise RuntimeError(f"nvcc not found (looked in {cand} and PATH)")
    return found


def build() -> Path:
    """Compile every csrc/*.cu (in parallel) unless this source hash is
    already built; returns the directory holding the libraries."""
    out = BUILD_ROOT / source_hash()
    libs = {n: out / f"lib{n}.so" for n in SIGNATURES}
    if all(p.exists() for p in libs.values()):
        return out
    nvcc = _nvcc()
    out.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name, lib in libs.items():
        tmp = lib.with_name(f"lib{name}.{os.getpid()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        build_info.setdefault("ptxas", {})[name] = log
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu (rc={proc.returncode}) ---\n{log}")
        else:
            os.replace(tmp, libs[name])
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    build_info["seconds"] = time.perf_counter() - t0
    return out


def function(name: str):
    """The bound C entry point of csrc/<name>.cu (building on first use)."""
    fn = _fns.get(name)
    if fn is None:
        with _lock:
            if not _fns:
                out = build()
                build_info["dir"] = str(out)
                for src, (sym, argtypes) in SIGNATURES.items():
                    f = getattr(ctypes.CDLL(str(out / f"lib{src}.so")), sym)
                    f.argtypes = argtypes
                    f.restype = ctypes.c_int
                    _fns[src] = f
            fn = _fns[name]
    return fn


def prepare(name: str, dev: torch.device):
    """csrc/<name>.cu's entry point for a launch on `dev`: raises on a
    card below capability (9, 0) (read once per device) and, through
    `function`, on a failed build."""
    if dev not in _hopper:
        if torch.cuda.get_device_capability(dev) < (9, 0):
            raise RuntimeError(f"{dev} is older than Hopper: the kernels "
                               "are built for sm_90a only")
        _hopper.add(dev)
    return _fns.get(name) or function(name)


def launch(name: str, *args) -> None:
    """Call csrc/<name>.cu's entry point on the current stream of the
    first tensor's device. Tensors pass as data_ptr(); raises on a card
    below capability (9, 0) and on a non-zero cudaGetLastError()
    returned by the C side. A device context is entered only when the
    device is not current: the reduce side pays this host work on each
    of its ~10^4 launches a run."""
    dev = next(a.device for a in args if isinstance(a, torch.Tensor))
    fn = prepare(name, dev)
    c_args = [a.data_ptr() if isinstance(a, torch.Tensor) else int(a)
              for a in args]
    if dev.index == torch.cuda.current_device():
        rc = fn(*c_args, torch.cuda.current_stream(dev).cuda_stream)
    else:
        with torch.cuda.device(dev):
            rc = fn(*c_args, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed: cudaError {rc}")


def count_launch(wrapper) -> None:
    """Add one to `wrapper.launches`. Reduce sinks launch from several
    threads, and `+=` on an attribute is not atomic."""
    with _count_lock:
        wrapper.launches += 1
