"""Build, load and launch the package's CUDA kernels.

The sources in blockmaze_tpu_torch/csrc are compiled at first use with
    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC
into blockmaze_tpu_torch/_build/ (one shared library with a plain C
interface, named by a hash of the sources, so an edit rebuilds; one nvcc
process per .cu file, all started together; build(verbose=True) prints
each file's seconds and ptxas report), and loaded with ctypes. Processes
that start together (one per card) take turns on a lock file in
_build/: the first builds, the others wait and load its library. Every
entry point takes int32/uint8 device pointers and the current stream,
launches, and returns cudaGetLastError(); a nonzero code raises. A failed
build or load raises too: there is no fallback.

Each kernel has a `Kernel` object whose `launches` count goes up by one
each time its wrapper launches it, so a run can show which kernels it went
through.

Host code in csrc/*.cpp builds the same way at first use, with g++, the
host compiler nvcc itself calls, into its own library in _build/
(host_library); the CPU tests build and run the very same files. HOST_LIBS
is the one table of them: per source its extra g++ flags, whether it is
loaded with the interpreter lock held through each call (ctypes.PyDLL) or
released (ctypes.CDLL), and its entry points' argtypes and restypes;
host_lib(source) builds and binds it once a process:

    keyparse.cpp    the key-text tokenizer (serialization/native_io.py)
    wirelimbs.cpp   the prover's witness words; reads Python objects, so
                    it takes the interpreter's headers and holds the lock
    hostcurve.cpp   the proof's host group law (curves/native.py), -O3
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import sysconfig
import tempfile
import time
from typing import NamedTuple

import torch

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(PKG, "csrc")
BUILD = os.path.join(PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]
HOST_FLAGS = ["-std=c++17", "-O2", "-shared", "-fPIC"]

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int

# Curve codes of the C entry points.
CURVE_ID = {"g1": 1, "g2": 2}

# C entry points and their argument types (csrc/*.cu); each returns
# cudaGetLastError() as an int.
SIGNATURES = {
    "bm_fft_pass": [_P] * 4 + [_I] * 7 + [_P] * 4,
    "bm_butterfly_stage": [_P, _P, _P, _LL, _LL, _P],
    "bm_mul_elementwise": [_P, _P, _P, _LL, _I, _P],
    "bm_qap_matvec": [_P] * 6 + [_I] * 3 + [_P],
    "bm_step_pre": [_P] * 4 + [_I] * 2 + [_P],
    "bm_step_post": [_P] * 9 + [_I] * 2 + [_P],
    "bm_qap_combine": [_P] * 5 + [_LL, _P],
    "bm_point_add": [_I] + [_P] * 9 + [_LL, _P],
    "bm_point_double": [_I] + [_P] * 6 + [_LL, _P],
    "bm_point_mixed_add": [_I, _I] + [_P] * 9 + [_LL, _P],
    "bm_msm_accumulate": [_I, _I] + [_P] * 7 + [_I, _LL, _LL] + [_P] * 11
                         + [_P],
    "bm_msm_combine": [_I, _I, _LL] + [_P] * 5 + [_I, _I] + [_P] * 9
                      + [_P],
    "bm_msm_triangle": [_I, _I, _I] + [_P] * 3 + [_I, _I, _I] + [_P] * 10
                       + [_P],
    "bm_msm_fold": [_I, _P, _P, _P, _I, _I, _P, _P, _P, _P],
    "bm_fixed_base_exp": [_I] + [_P] * 8 + [_LL, _P],
    "bm_decompress": [_I] + [_P] * 7 + [_LL, _P],
    "bm_wire_widen": [_P, _P, _LL, _P, _LL, _P],
}


class HostLib(NamedTuple):
    """One host source of csrc/: its g++ flags after HOST_FLAGS, whether
    its calls hold the interpreter lock (it reads Python objects), and
    {entry point: (argtypes, restype)}."""
    flags: tuple
    holds_lock: bool
    entries: dict


HOST_LIBS = {
    "keyparse.cpp": HostLib((), False, {
        "bm_keytext_parse": ([ctypes.c_char_p, ctypes.POINTER(_LL),
                              ctypes.c_char_p, _I], _P),
        "bm_keytext_fill": ([_P] * 17, None),
        "bm_keytext_free": ([_P], None)}),
    "wirelimbs.cpp": HostLib(
        ("-I" + sysconfig.get_paths()["include"],), True, {
            "bm_wire_words": ([ctypes.py_object, ctypes.py_object, _P, _LL,
                               _P], _LL)}),
    "hostcurve.cpp": HostLib(("-O3",), False, {
        "bm_hc_mul": ([_I, _P, _P, _P], _I),
        "bm_hc_add": ([_I, _P, _P, _P], _I),
        "bm_hc_msub": ([_I, _P, _P, _P, _P], _I),
        "bm_hc_unblind": ([_I] + [_P] * 6, _I),
        "bm_hc_combine": ([_P] * 4, _I),
        "bm_hc_muls": ([], _LL)}),
}


def _bind(dll, entries: dict):
    """dll with every entry point's argtypes and restype set (entries:
    {name: (argtypes, restype)}); ctypes keeps each bound function on dll,
    so a call looks nothing up again."""
    for name, (argtypes, restype) in entries.items():
        fn = getattr(dll, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return dll


class BuildError(RuntimeError):
    pass


def _sources():
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith((".cu", ".cuh")))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise BuildError("nvcc not found (set CUDA_HOME)")
    return found


def _hashed_path(prefix: str, srcs, flags) -> str:
    """_build/<prefix>_<hash of the sources' names and bytes and the
    flags>.so"""
    h = hashlib.sha256()
    for s in srcs:
        with open(s, "rb") as f:
            h.update(os.path.basename(s).encode() + b"\0" + f.read())
    h.update(" ".join(flags).encode())
    return os.path.join(BUILD, f"{prefix}_{h.hexdigest()[:16]}.so")


def _locked_build(lib: str, make):
    """make() under an exclusive lock on _build/build.lock (released when
    this process ends, however it ends), unless lib exists by then."""
    if os.path.exists(lib):
        return lib
    os.makedirs(BUILD, exist_ok=True)
    with open(os.path.join(BUILD, "build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(lib):     # another process built it meanwhile
            make()
    return lib


def host_library(source: str, flags=()) -> str:
    """Compile the host C++ file csrc/<source> with g++ (HOST_FLAGS, then
    flags) into _build/ if that exact source has not been built with those
    flags yet; return the library path. A failed build raises
    BuildError."""
    src = os.path.join(CSRC, source)
    stem = os.path.splitext(source)[0]
    flags = [*HOST_FLAGS, *flags]
    lib = _hashed_path(f"libbm{stem}", [src], flags)

    def make():
        cxx = shutil.which("g++")
        if cxx is None:
            raise BuildError(f"g++ not found: {source} needs the C++ "
                             "compiler nvcc uses")
        with tempfile.TemporaryDirectory(dir=BUILD) as tmp:
            out = os.path.join(tmp, "lib.so")
            res = subprocess.run([cxx, *flags, "-o", out, src],
                                 capture_output=True, text=True)
            if res.returncode != 0:
                raise BuildError(f"g++ failed on {source}:\n{res.stderr}")
            os.replace(out, lib)

    return _locked_build(lib, make)


@functools.cache
def host_lib(source: str):
    """HOST_LIBS[source] built (host_library) and loaded with its entry
    points bound, once a process."""
    spec = HOST_LIBS[source]
    load = ctypes.PyDLL if spec.holds_lock else ctypes.CDLL
    return _bind(load(host_library(source, spec.flags)), spec.entries)


def library_path() -> str:
    """Where build() puts the kernel library of the current sources (it
    exists once they have been built)."""
    return _hashed_path("libbmkernels", _sources(), NVCC_FLAGS)


def build(verbose: bool = False) -> str:
    """Compile csrc/*.cu into _build/ if that exact source set has not been
    built yet; return the library path. The .cu files compile in parallel
    nvcc processes and link into one shared library, under an exclusive
    lock on _build/build.lock (released when this process ends, however it
    ends)."""
    srcs = _sources()
    lib = library_path()
    return _locked_build(lib, lambda: _compile(srcs, lib, verbose))


def _compile(srcs, lib: str, verbose: bool):
    nvcc = _nvcc()
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    with tempfile.TemporaryDirectory(dir=BUILD) as tmp:
        procs = []
        for src in (s for s in srcs if s.endswith(".cu")):
            obj = os.path.join(tmp, os.path.basename(src) + ".o")
            cmd = [nvcc, *compile_flags, *(["-Xptxas", "-v"] if verbose
                                           else []), "-c", src, "-o", obj]
            out = open(obj + ".log", "w+")
            procs.append((src, obj, out, subprocess.Popen(
                cmd, stdout=out, stderr=subprocess.STDOUT)))
        t0 = time.perf_counter()
        secs = {}
        while len(secs) < len(procs):
            for src, _, _, proc in procs:
                if src not in secs and proc.poll() is not None:
                    secs[src] = time.perf_counter() - t0
            time.sleep(0.05)
        objs, errors = [], []
        for src, obj, out, proc in procs:
            out.seek(0)
            text = out.read()
            out.close()
            if verbose:
                print(f"{os.path.basename(src)}: {secs[src]:.1f}s\n{text}",
                      flush=True)
            if proc.returncode != 0:
                errors.append(text)
            objs.append(obj)
        if errors:
            raise BuildError("nvcc failed:\n" + "\n".join(errors))
        out_tmp = os.path.join(tmp, "lib.so")
        res = subprocess.run([nvcc, *NVCC_FLAGS, "-o", out_tmp, *objs],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise BuildError(f"nvcc link failed:\n{res.stderr}")
        os.replace(out_tmp, lib)


@functools.cache
def kernel_lib():
    """The kernel library (build()) loaded, every entry point of
    SIGNATURES bound, once a process."""
    return _bind(ctypes.CDLL(build()), {name: (argtypes, _I)
                                        for name, argtypes in
                                        SIGNATURES.items()})


class Kernel:
    """One hand-written kernel: its C entry point and its launch count."""

    def __init__(self, name: str, entry: str, source: str, replaces: str):
        self.name = name
        self.entry = entry
        self.source = source
        self.replaces = replaces
        self.launches = 0

    def __call__(self, *args):
        """Launch on the card of the first tensor argument, on that card's
        current stream, with that card current (an entry point's attribute
        calls apply to the current device); tensor arguments pass as their
        device pointers."""
        fn = getattr(kernel_lib(), self.entry)
        dev = next(a.device for a in args if isinstance(a, torch.Tensor))
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = fn(*(a.data_ptr() if isinstance(a, torch.Tensor) else a
                      for a in args), stream)
        if rc != 0:
            raise RuntimeError(f"{self.name}: CUDA launch failed with error "
                               f"{rc}")
        self.launches += 1


def check_cuda(name: str, *tensors, counts=()):
    """Validate what a kernel takes: CUDA, all on one card, and contiguous;
    coordinates, keys and ids int32, masks uint8, and only the tensors
    passed as `counts` int64."""
    cards = {t.device for t in tensors + tuple(counts)}
    if len(cards) > 1:
        raise ValueError(f"{name}: tensors on more than one device: "
                         f"{sorted(map(str, cards))}")
    for t, dtypes in ([(t, (torch.int32, torch.uint8)) for t in tensors]
                      + [(t, (torch.int64,)) for t in counts]):
        if not t.is_cuda:
            raise ValueError(f"{name}: expected CUDA tensors, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous tensors")
        if t.dtype not in dtypes:
            raise ValueError(f"{name}: expected {' or '.join(map(str, dtypes))}"
                             f", got {t.dtype}")


def check_aligned(name: str, *tensors):
    """Raise unless every tensor starts on a 16-byte boundary (kernels that
    read 16-byte chunks; a sliced view may not)."""
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: tensors must be 16-byte aligned (the "
                         f"kernel reads 16-byte chunks)")


def on_cpu(*tensors) -> bool:
    """True if every tensor lies on the CPU (the plain version's domain);
    False if every one is on one and the same card; raises on anything
    else (mixed kinds, or more than one card)."""
    devs = {t.device for t in tensors}
    kinds = {d.type for d in devs}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"} and len(devs) == 1:
        return False
    raise ValueError(f"tensors on unsupported/mixed devices: "
                     f"{sorted(map(str, devs))}")


PLAIN_ROWS = 1 << 16


def plain_by_rows(fn, *tensors, rows: int | None = None):
    """fn (a plain version) over the tensors' leading rows, `rows` (default
    PLAIN_ROWS) at a time, its outputs (a tensor or a tuple of them)
    joined: a plain Montgomery product builds (n, 16, 16) int64
    temporaries, gigabytes for a whole proving key at once."""
    n, rows = tensors[0].shape[0], rows or PLAIN_ROWS
    if n <= rows:
        return fn(*tensors)
    parts = [fn(*(t[i:i + rows] for t in tensors)) for i in range(0, n, rows)]
    if isinstance(parts[0], tuple):
        return tuple(torch.cat(p) for p in zip(*parts))
    return torch.cat(parts)


K = {
    # the whole FFT (bit-reversal gather + every stage), one launch per pass;
    # the prove path's counterpart of the per-stage TPU butterfly
    "fft": Kernel("fft", "bm_fft_pass", "blockmaze_tpu_torch/csrc/pntt.cu",
                  "blockmaze_tpu/ntt/pntt.py:30"),
    "butterfly": Kernel("butterfly", "bm_butterfly_stage",
                        "blockmaze_tpu_torch/csrc/pntt.cu",
                        "blockmaze_tpu/ntt/pntt.py:30"),
    "mul_elementwise": Kernel("mul_elementwise", "bm_mul_elementwise",
                              "blockmaze_tpu_torch/csrc/pntt.cu",
                              "blockmaze_tpu/ntt/pntt.py:61"),
    # K2's QAP roles, with the field ops around them, redesigned
    "qap_matvec": Kernel("qap_matvec", "bm_qap_matvec",
                         "blockmaze_tpu_torch/csrc/qap.cu",
                         "blockmaze_tpu/ntt/pntt.py:61"),
    "step_pre": Kernel("step_pre", "bm_step_pre",
                       "blockmaze_tpu_torch/csrc/qap.cu",
                       "blockmaze_tpu/ntt/pntt.py:61"),
    "step_post": Kernel("step_post", "bm_step_post",
                        "blockmaze_tpu_torch/csrc/qap.cu",
                        "blockmaze_tpu/ntt/pntt.py:61"),
    "qap_combine": Kernel("qap_combine", "bm_qap_combine",
                          "blockmaze_tpu_torch/csrc/qap.cu",
                          "blockmaze_tpu/ntt/pntt.py:61"),
    "add": Kernel("add", "bm_point_add",
                  "blockmaze_tpu_torch/csrc/pcurve.cu",
                  "blockmaze_tpu/curves/pcurve.py:129"),
    "double": Kernel("double", "bm_point_double",
                     "blockmaze_tpu_torch/csrc/pcurve.cu",
                     "blockmaze_tpu/curves/pcurve.py:141"),
    "msm_round": Kernel("msm_round", "bm_msm_accumulate",
                        "blockmaze_tpu_torch/csrc/pippenger.cu",
                        "blockmaze_tpu/msm/pippenger.py:193"),
    "msm_combine": Kernel("msm_combine", "bm_msm_combine",
                          "blockmaze_tpu_torch/csrc/combine.cu",
                          "blockmaze_tpu/curves/pcurve.py:129"),
    "msm_triangle": Kernel("msm_triangle", "bm_msm_triangle",
                           "blockmaze_tpu_torch/csrc/triangle.cu",
                           "blockmaze_tpu/curves/pcurve.py:129"),
    "msm_fold": Kernel("msm_fold", "bm_msm_fold",
                       "blockmaze_tpu_torch/csrc/fold.cu",
                       "blockmaze_tpu/msm/pippenger.py:288"),
    "mixed_add": Kernel("mixed_add", "bm_point_mixed_add",
                        "blockmaze_tpu_torch/csrc/pcurve.cu",
                        "blockmaze_tpu/curves/pcurve.py:102"),
    "mixed_add_noexc": Kernel("mixed_add_noexc", "bm_point_mixed_add",
                              "blockmaze_tpu_torch/csrc/pcurve.cu",
                              "blockmaze_tpu/curves/pcurve.py:115"),
    # keygen's whole window ladder (K7 and K8 in that role) and the affine
    # normalisation, one launch per query
    "fixed_base_exp": Kernel("fixed_base_exp", "bm_fixed_base_exp",
                             "blockmaze_tpu_torch/csrc/fixed_base.cu",
                             "blockmaze_tpu/curves/pcurve.py:102,115"),
    # the proving key's point decompression (text keys), one thread a
    # point; the JAX package did it on the host (C++ over GMP), not in
    # Pallas
    "decompress_g1": Kernel("decompress_g1", "bm_decompress",
                            "blockmaze_tpu_torch/csrc/keyload.cu",
                            "blockmaze_tpu/native/keyparse.cpp:138"),
    "decompress_g2": Kernel("decompress_g2", "bm_decompress",
                            "blockmaze_tpu_torch/csrc/keyload.cu",
                            "blockmaze_tpu/native/keyparse.cpp:265"),
    # the witness's 8-byte words (and its few wide rows) to standard-form
    # limbs on the card; no TPU kernel: the JAX package uploaded the host's
    # 64-byte limb rows (jnp.asarray of ints_to_limbs)
    "wire_widen": Kernel("wire_widen", "bm_wire_widen",
                         "blockmaze_tpu_torch/csrc/widen.cu",
                         "blockmaze_tpu/groth16/prover.py:322"),
}


def reset_counts():
    for k in K.values():
        k.launches = 0


def counts() -> dict:
    return {name: k.launches for name, k in K.items()}
