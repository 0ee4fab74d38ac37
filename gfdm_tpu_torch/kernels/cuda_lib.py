"""Build and bind the hand-written CUDA kernels of ``gfdm_tpu_torch/csrc``.

The sources are compiled with ``nvcc`` for Hopper (``sm_90a``), one ``nvcc``
process a source, all started together, and linked into one shared library
with a plain C interface, loaded with :mod:`ctypes`. The library is built on
first use into :func:`build_dir` (``build/gfdm_tpu_torch/`` at the root of a
checkout) and rebuilt when a hash of the sources or flags changes.
Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

__all__ = ["Dims", "Consts", "Act", "LinkIO", "DetectDims", "FactoredDims", "FactoredConsts",
           "ViterbiTables", "library", "launch", "build_dir", "build_info"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("tx.cu", "rx.cu", "link.cu", "detect.cu", "factored.cu", "chain.cu", "viterbi.cu")
HEADERS = ("gfdm_common.cuh", "link_gemm.cuh", "hopper_gemm.cuh", "fma_gemm.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


class Dims(ctypes.Structure):
    """Mirror of ``gfdm::Dims`` in csrc/gfdm_common.cuh (same field order)."""

    _fields_ = [(name, ctypes.c_int) for name in (
        "batch", "n", "n_data", "timeslots", "subcarriers", "half",
        "frame_len", "preamble_len", "cp_len", "cs_len",
        "n_ports", "n_cnr", "met_w", "ic_iterations", "ic_mode",
        "dec_kind", "equalizer", "phase_comp", "n_act", "overlap", "bf16", "sum64",
    )]


class Consts(ctypes.Structure):
    """Mirror of ``gfdm::Consts`` in csrc/gfdm_common.cuh: device pointers."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "t_g", "win", "pre", "shifts", "e_g", "f_g", "bfd_g", "f2_g", "act",
        "sig_idx", "noise_idx", "demap_idx", "taps", "icop", "cnri", "parts", "ifm",
    )]


class Act(ctypes.Structure):
    """Mirror of ``gfdm::lg::Act`` in csrc/link_gemm.cuh: an activation whose
    row r, plane q, column k sits at ``p[r * ld + q * im + k]``, ``n``
    columns a plane."""

    _fields_ = [("p", ctypes.c_void_p), ("ld", ctypes.c_int), ("im", ctypes.c_int),
                ("n", ctypes.c_int)]


class LinkIO(ctypes.Structure):
    """Mirror of ``gfdm::lg::LinkIO`` in csrc/link_gemm.cuh: the staged
    stages' inputs, outputs, intermediates and inverse demap (device
    pointers), and the windows P and F the stages read."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "data", "out", "met", "f", "y", "d0", "pw", "pre", "inv_demap",
    )] + [("p_in", Act), ("f_in", Act)] + [(name, ctypes.c_void_p) for name in (
        "chan", "sym", "q",
    )]


class DetectDims(ctypes.Structure):
    """Mirror of ``gfdm::DetectDims`` in csrc/detect.cu (same field order)."""

    _fields_ = [(name, ctypes.c_int) for name in (
        "batch", "length", "subcarriers", "cp_len", "n_ac", "n_valid",
    )]


class FactoredDims(ctypes.Structure):
    """Mirror of ``gfdm::FactoredDims`` in csrc/factored.cu (same field order)."""

    _fields_ = [(name, ctypes.c_int) for name in (
        "batch", "n", "timeslots", "subcarriers", "overlap", "n_data",
        "frame_len", "preamble_len", "cp_len", "shift", "ic_iterations",
    )]


class FactoredConsts(ctypes.Structure):
    """Mirror of ``gfdm::FactoredConsts`` in csrc/factored.cu: device pointers."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "fk", "tw", "fm", "ifm", "parts", "taps", "act", "map_idx", "win",
        "pre",
    )]


class ViterbiTables(ctypes.Structure):
    """Mirror of ``gfdm::ViterbiTables`` in csrc/viterbi.cu: the pattern
    index of transition (ns, j) is ``q_j[j] ^ q_ns[ns]``."""

    _fields_ = [("q_j", ctypes.c_int * 16), ("q_ns", ctypes.c_int * 64)]


_LIB = None
_BUILD_INFO: dict = {}


def _nvcc() -> str:
    for env in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(env)
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def build_dir() -> Path:
    """Where the library is built: ``$GFDM_TPU_TORCH_BUILD_DIR`` if set, else
    ``build/gfdm_tpu_torch`` at the root of a source checkout, else (an
    installed package) ``gfdm_tpu_torch`` under the user's cache directory."""
    env = os.environ.get("GFDM_TPU_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    root = Path(__file__).resolve().parents[2]
    if (root / "pyproject.toml").exists():
        return root / "build" / "gfdm_tpu_torch"
    cache = os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache"
    return Path(cache) / "gfdm_tpu_torch"


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in HEADERS + SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _build() -> Path:
    out_dir = build_dir()
    lib_path = out_dir / f"libgfdm_kernels_{_source_hash()}.so"
    log_path = out_dir / f"{lib_path.stem}.log"
    if lib_path.exists():
        log = log_path.read_text() if log_path.exists() else ""
        _BUILD_INFO.update(path=str(lib_path), seconds=0.0, cached=True, log=log)
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs = [str(Path(tmp) / f"{Path(src).stem}.o") for src in SOURCES]
        procs = [
            subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(CSRC / src)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(SOURCES, objs)
        ]
        logs = [f"== {src}\n{proc.communicate()[0]}" for src, proc in zip(SOURCES, procs)]
        failed = [src for src, proc in zip(SOURCES, procs) if proc.returncode != 0]
        if failed:
            raise RuntimeError(f"nvcc failed on {', '.join(failed)}:\n" + "\n".join(logs))
        tmp_lib = str(Path(tmp) / lib_path.name)
        link = subprocess.run([nvcc, "-shared", "-o", tmp_lib, *objs],
                              capture_output=True, text=True, check=False)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}\n{link.stderr}")
        os.replace(tmp_lib, lib_path)
    seconds = time.perf_counter() - t0
    log = "\n".join(logs)
    log_path.write_text(log)
    _BUILD_INFO.update(path=str(lib_path), seconds=seconds, cached=False, log=log)
    return lib_path


def library() -> ctypes.CDLL:
    """The kernel library, built on first call."""
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = ctypes.CDLL(str(_build()))
    dims_p, consts_p, vp = ctypes.POINTER(Dims), ctypes.POINTER(Consts), ctypes.c_void_p
    lib.gfdm_tx.argtypes = [dims_p, consts_p, vp, vp, vp]
    lib.gfdm_tx_tile.argtypes = [ctypes.POINTER(ctypes.c_int)]
    ci, cf = ctypes.c_int, ctypes.c_float
    lib.gfdm_link_stage.argtypes = [dims_p, consts_p, ctypes.POINTER(LinkIO), ci, ci, vp]
    lib.gfdm_tf32_split.argtypes = [ci, vp, vp, vp, vp]
    lib.gfdm_link_io_size.argtypes = []
    lib.gfdm_rx_variant.argtypes = [dims_p, consts_p, vp, vp, vp, vp, vp, ci, ci, vp]
    lib.gfdm_struct_sizes.argtypes = [ctypes.POINTER(ctypes.c_int)]
    det_p = ctypes.POINTER(DetectDims)
    for fn in (lib.gfdm_detect_front, lib.gfdm_detect_lean):
        fn.argtypes = [det_p, vp, vp, vp, vp, vp, vp, vp]
    lib.gfdm_detect_dims_size.argtypes = []
    lib.gfdm_detect_tile.argtypes = [ctypes.POINTER(ctypes.c_int)]
    fdims_p, fconsts_p = ctypes.POINTER(FactoredDims), ctypes.POINTER(FactoredConsts)
    lib.gfdm_tx_factored.argtypes = [fdims_p, fconsts_p, vp, vp, vp]
    lib.gfdm_rx_factored.argtypes = [fdims_p, fconsts_p, vp, vp, vp, vp, vp]
    lib.gfdm_rx_estimate.argtypes = [fdims_p, vp, vp, vp, vp]
    lib.gfdm_rx_factored_chan.argtypes = [fdims_p, fconsts_p, vp, vp, vp, vp]
    lib.gfdm_rx_estimate_tile.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.gfdm_factored_struct_sizes.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.gfdm_factored_plan.argtypes = [ci, ctypes.POINTER(ctypes.c_int)]
    lib.gfdm_chain.argtypes = [ci, ci, ci, ci, vp, vp, vp, vp, cf, cf, cf, vp, vp, vp, vp]
    lib.gfdm_chain_int8_clusters.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.gfdm_viterbi.argtypes = [ctypes.POINTER(ViterbiTables), ci, ci, ci, vp, vp, vp, vp, vp,
                                 vp]
    lib.gfdm_viterbi_scratch_bytes.argtypes = [ci, ci, ctypes.POINTER(ctypes.c_size_t), vp]
    lib.gfdm_viterbi_tables_size.argtypes = []
    lib.gfdm_peek_error.argtypes = []
    lib.gfdm_set_device.argtypes = [ci]
    for fn in (lib.gfdm_tx, lib.gfdm_tx_tile, lib.gfdm_link_stage, lib.gfdm_tf32_split,
               lib.gfdm_link_io_size, lib.gfdm_rx_variant, lib.gfdm_struct_sizes,
               lib.gfdm_detect_front, lib.gfdm_detect_lean,
               lib.gfdm_detect_dims_size, lib.gfdm_detect_tile, lib.gfdm_tx_factored,
               lib.gfdm_rx_factored, lib.gfdm_rx_estimate, lib.gfdm_rx_factored_chan,
               lib.gfdm_rx_estimate_tile,
               lib.gfdm_factored_struct_sizes, lib.gfdm_factored_plan, lib.gfdm_chain,
               lib.gfdm_chain_int8_clusters, lib.gfdm_viterbi, lib.gfdm_viterbi_scratch_bytes,
               lib.gfdm_viterbi_tables_size,
               lib.gfdm_peek_error, lib.gfdm_set_device):
        fn.restype = ctypes.c_int
    lib.gfdm_error_string.argtypes = [ctypes.c_int]
    lib.gfdm_error_string.restype = ctypes.c_char_p
    lib.gfdm_rx_smem_bytes.argtypes = [dims_p]
    lib.gfdm_rx_smem_bytes.restype = ctypes.c_size_t
    lib.gfdm_detect_smem_bytes.argtypes = [det_p]
    lib.gfdm_detect_smem_bytes.restype = ctypes.c_size_t
    lib.gfdm_factored_smem_bytes.argtypes = [fdims_p]
    lib.gfdm_factored_smem_bytes.restype = ctypes.c_size_t
    sizes = (ctypes.c_int * 2)()
    lib.gfdm_struct_sizes(sizes)
    fsizes = (ctypes.c_int * 2)()
    lib.gfdm_factored_struct_sizes(fsizes)
    c_sizes = (sizes[0], sizes[1], lib.gfdm_link_io_size(), lib.gfdm_detect_dims_size(),
               fsizes[0], fsizes[1], lib.gfdm_viterbi_tables_size())
    py_sizes = tuple(ctypes.sizeof(t) for t in (Dims, Consts, LinkIO, DetectDims,
                                                FactoredDims, FactoredConsts, ViterbiTables))
    if c_sizes != py_sizes:
        raise RuntimeError(
            f"kernel struct layout mismatch (Dims, Consts, LinkIO, DetectDims, FactoredDims, "
            f"FactoredConsts, ViterbiTables): C {c_sizes} vs ctypes {py_sizes}"
        )
    _LIB = lib
    return lib


def launch(name: str, args: tuple, device, hint=None) -> None:
    """Call the C launcher ``name`` on the current stream of ``device``.

    ``args`` precede the stream argument. A nonzero return (a refused
    launch: too much shared memory, a bad configuration) raises, with
    ``hint(lib)`` appended when given.
    """
    lib = library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, name)(*args, stream)
    if rc != 0:
        msg = lib.gfdm_error_string(rc).decode()
        extra = hint(lib) if hint is not None else ""
        raise RuntimeError(f"{name} kernel failed to launch: {msg} ({rc}){extra}")


def build_info() -> dict:
    """Path, build seconds, whether it was cached, and the nvcc log (a
    cached library's: the one its build left beside it)."""
    library()
    return dict(_BUILD_INFO)
