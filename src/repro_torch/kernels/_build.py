"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<source>.cu`` exposes plain C entry points (one per kernel;
``gather_rank.cu`` holds two) and is compiled on first use by ``nvcc``
into its own shared library under ``build/repro_torch/`` at the root of
the checkout::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v \
         -o build/repro_torch/<source>-<hash>.so csrc/<source>.cu

The library's name carries a content hash of its source and of every
shared header ``csrc/*.cuh``, so an edited kernel or header is rebuilt
and a stale library is never loaded.  The compiler's report (``-Xptxas
-v``: registers, shared memory and spills of each kernel) is kept beside
the library and read back by :func:`ptxas_report`.  Libraries are
loaded with ``ctypes``; every entry point takes its pointers and the
CUDA stream as ``c_void_p`` and returns ``cudaGetLastError()``.

Nothing here runs at import time: the CPU tests import every module of
the package, and the build needs the CUDA toolkit.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

#: each kernel's entry point: name -> (source file stem, symbol, argtypes)
_P, _I = ctypes.c_void_p, ctypes.c_int
ENTRY_POINTS = {
    # x, a, out, n, d, words, stream
    "lsh_hash": ("lsh_hash", "lsh_hash_launch", [_P, _P, _P, _I, _I, _I, _P]),
    # q, store, slots, valid, out, nq, n_rows, c, d, angular, stream
    "gather_rank": ("gather_rank", "gather_rank_launch",
                    [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]),
    # q, store, staging, slots, valid, out, nq, n_rows, n_staging, c, d,
    # angular, stream
    "gather_rank_staged": ("gather_rank", "gather_rank_staged_launch",
                           [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                            _P]),
    # q, x, out, nq, n, ld (out's row pitch), d, stream
    "pair_dist": ("pair_dist", "pair_dist_launch",
                  [_P, _P, _P, _I, _I, _I, _I, _P]),
    # q, x, out, nq, c, d, stream
    "rank_dots": ("rank_dots", "rank_dots_launch",
                  [_P, _P, _P, _I, _I, _I, _P]),
    # a, b, out, nq, n, w, stream
    "hamming": ("hamming", "hamming_launch", [_P, _P, _P, _I, _I, _I, _P]),
}

_FNS: dict = {}                   # name -> loaded entry point
#: kernel launches since the last reset; each launch adds one, and nothing
#: else does (chip_smoke.py reads these to prove the path used the kernels)
LAUNCHES = {name: 0 for name in ENTRY_POINTS}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                       "build the repro_torch kernels")


def _lib_path(source: str) -> Path:
    h = hashlib.sha256((CSRC / f"{source}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    return BUILD_DIR / f"{source}-{h.hexdigest()[:16]}.so"


def _report_path(lib: Path) -> Path:
    return lib.with_suffix(".ptxas.txt")


def build(names=None) -> dict[str, float]:
    """Compile the sources of every named kernel (default: all) that have
    no library for their current content, one ``nvcc`` per source, all
    started together.  Returns the wall seconds each source's build took
    (0.0 where it was cached).  Raises with the compiler's output if any
    build fails."""
    names = list(ENTRY_POINTS if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, secs = {}, {}
    for source in dict.fromkeys(ENTRY_POINTS[n][0] for n in names):
        out = _lib_path(source)
        if out.exists():
            secs[source] = 0.0
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *ARCH_FLAGS, *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / f"{source}.cu")]
        procs[source] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT),
                       tmp, out, time.perf_counter())
    failed = []
    for source, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        secs[source] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{source}: nvcc exit {proc.returncode}\n"
                          f"{log.decode(errors='replace')}")
            tmp.unlink(missing_ok=True)
        else:
            _report_path(out).write_bytes(log)
            os.replace(tmp, out)        # atomic: never load a partial .so
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return secs


def ptxas_report(names=None) -> list[dict]:
    """Registers, shared memory and spill bytes of every kernel in the
    built sources of the named kernels (default: all), from the
    ``-Xptxas -v`` report kept beside each library; a source built
    before the report was kept gives no entries.  Kernel names are
    demangled by ``c++filt`` where it is on the PATH."""
    names = list(ENTRY_POINTS if names is None else names)
    rows = []
    for source in dict.fromkeys(ENTRY_POINTS[n][0] for n in names):
        path = _report_path(_lib_path(source))
        if path.exists():
            rows += parse_ptxas(path.read_text(errors="replace"), source)
    filt = shutil.which("c++filt")
    if filt and rows:
        out = subprocess.run([filt], capture_output=True, text=True,
                             input="\n".join(r["kernel"] for r in rows),
                             timeout=60)
        plain = out.stdout.splitlines()
        if out.returncode == 0 and len(plain) == len(rows):
            for r, name in zip(rows, plain):
                r["kernel"] = name
    return rows


def parse_ptxas(log: str, source: str) -> list[dict]:
    """One dict per kernel (entry function, by its mangled name) in an
    ``-Xptxas -v`` log."""
    rows = []
    for block in log.split("Compiling entry function")[1:]:
        mangled = block.split("'")[1] if "'" in block else block.split()[0]
        regs = re.search(r"Used (\d+) registers", block)
        smem = re.search(r"(\d+) bytes smem", block)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", block)
        rows.append(dict(
            source=source, kernel=mangled,
            registers=int(regs.group(1)) if regs else None,
            static_smem_bytes=int(smem.group(1)) if smem else 0,
            spill_store_bytes=int(spill.group(1)) if spill else None,
            spill_load_bytes=int(spill.group(2)) if spill else None))
    return rows


def load(name: str):
    """The C entry point of kernel ``name``, building it on first use."""
    fn = _FNS.get(name)
    if fn is None:
        source, symbol, argtypes = ENTRY_POINTS[name]
        path = _lib_path(source)
        if not path.exists():
            build([name])
        fn = getattr(ctypes.CDLL(str(path)), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return fn


def check(err: int, name: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
