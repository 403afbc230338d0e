"""Build and load the port's CUDA kernels (route (b): nvcc + ctypes).

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` process, all started
together, into a shared library with a plain C interface under
``libff_tpu_torch/_build/<hash>/``.  The hash covers every source and
header in ``csrc/`` and the compiler flags, so an edited source builds
anew and an unchanged tree loads what is there.  Nothing is built when the
package is imported: the first kernel launch builds, or a caller builds
ahead of time with :func:`build`.

Each C entry point returns ``cudaGetLastError()`` after its launch;
:func:`launch` raises on any value other than 0.

``LAUNCHES`` counts kernel launches by kernel and branch: "K1e", "K4e";
"K1e inv", "K4e inv" (the one-launch Fp and Fq2 inverses of fp_ops.cu);
"K2 sort g1", "K2 sort g2" (the insert's sort by bucket), "K2 g1", "K2
g2" (the insert's chains), "K2m g1", "K2m g2" (the insert with its fused
lane merge), "K3 g1", "K3 g2" (the batched group ops), "K3 scan g1",
"K3 scan g2" (K3's Horner scan), "K5 g1", "K5 g2" (the lane merge)
for the G1 and G2 branches; "K6 g1" (the v1 insert, G1 only).  K2, K2m
and K5 over the SOS products (``MsmConfig.kmul``) count under the same
names with the product appended, "K2 g1 sos", "K2m g2 sos2", "K5 g1 sos"
and so on; the CIOS names carry no suffix.  The field-mul benches count
as "K7a" (the no-stall op mix), "K7b cios", "K7b sos", "K7b sos2" (chains
of products), "K7b lone" (one chain a thread: a product's latency; at
12 limbs "K7b lone n12" and, over the scan's two-accumulator product,
"K7b lone eo n12"),
"K7c" (the issue-rate bodies) and "K7d cios", "K7d sos", "K7d sos2"
(chains of Fq2 products), and the batched-affine experiment as
"K7e madd", "K7e affine" and "K7e inv".  The kernels over 12-limb Fp
(BLS12-381 and BLS12-377, G1 and G2) count under the same names with the
width appended before any product: "K1e n12", "K1e inv n12", "K4e n12",
"K4e inv n12", "K2 g1 n12", "K2 g2 n12", "K2m g1 n12", "K2m g2 n12", "K3
g1 n12", "K3 g2 n12", "K3 scan g1 n12", "K3 scan g2 n12", "K5 g1 n12",
"K5 g2 n12", "K6 g1 n12", and over the SOS products "K2 g1 n12 sos",
"K2m g2 n12 sos2", "K5 g1 n12 sos" and so on (their sort is the
width-free "K2 sort g1" or "K2 sort g2").  A wrapper adds one where it
launches its kernel and nowhere else.

Each width has its own sources: csrc/<stem>.cu builds the 8-limb library
and csrc/<stem>_n12.cu the 12-limb one (:func:`width_stem`; over an SOS
product csrc/<stem>_<kmul>_n12.cu, :func:`kmul_stem` first), so nvcc
compiles them in parallel.
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

import torch

PKG = Path(__file__).resolve().parent
CSRC = PKG / "csrc"
BUILD = PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

LAUNCHES: collections.Counter = collections.Counter()

_libs: dict[str, ctypes.CDLL] = {}
_fns: dict[tuple[str, str], ctypes._CFuncPtr] = {}

# ctypes argument types shared by the entry points
VP = ctypes.c_void_p
U32P = ctypes.POINTER(ctypes.c_uint32)


def kmul_name(name: str, kmul: str) -> str:
    """The launch-count key of a kernel branch over the product kmul:
    the CIOS branch keeps the bare name."""
    return name if kmul == "cios" else f"{name} {kmul}"


def kmul_stem(stem: str, kmul: str) -> str:
    """The source (and library) that holds kernel `stem` over the product
    kmul: csrc/<stem>.cu for CIOS, csrc/<stem>_<kmul>.cu otherwise."""
    return stem if kmul == "cios" else f"{stem}_{kmul}"


def width_stem(stem: str, n32: int) -> str:
    """The source (and library) that holds kernel `stem` for a field of
    n32 32-bit limbs: csrc/<stem>.cu for 8, csrc/<stem>_n<n32>.cu for
    another width."""
    return stem if n32 == 8 else f"{stem}_n{n32}"


def width_name(name: str, n32: int) -> str:
    """The launch-count key of a kernel branch at n32 limbs: the 8-limb
    branch keeps the bare name."""
    return name if n32 == 8 else f"{name} n{n32}"


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    return BUILD / _digest()


def _compile(nvcc: str, src: Path, out: Path,
             defines: tuple[str, ...] = ()) -> tuple[str, float]:
    t0 = time.perf_counter()
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, *defines, "-I", str(CSRC), "-o", str(tmp),
           str(src)]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src.name}:\n{r.stdout}{r.stderr}")
    # ptxas -v: registers, spills and stack of every kernel
    out.with_suffix(".log").write_text(r.stdout + r.stderr)
    os.replace(tmp, out)
    return src.stem, time.perf_counter() - t0


def build() -> dict[str, float]:
    """Compile every csrc/*.cu that is not built yet, one nvcc each, in
    parallel.  Returns {source stem: seconds} for what was compiled."""
    out_dir = build_dir()
    todo = [s for s in _sources() if not (out_dir / f"{s.stem}.so").exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    with concurrent.futures.ThreadPoolExecutor(len(todo)) as ex:
        futs = [ex.submit(_compile, nvcc, s, out_dir / f"{s.stem}.so")
                for s in todo]
        return dict(f.result() for f in futs)


def build_variant(stem: str, defines: dict[str, int],
                  src: Path | None = None) -> Path:
    """Compile csrc/<stem>.cu, or `src` (another checkout's copy of it,
    which includes its own headers), with each macro of `defines` set by
    -D, into a directory of its own under the build; returns the
    library's path (its ptxas log beside it, as <stem>.log).  Load it with
    :func:`use_library`."""
    tag = "-".join(f"{k}={v}" for k, v in sorted(defines.items()))
    if src is not None:
        tag = "src-" + hashlib.sha256(src.read_bytes()).hexdigest()[:12] + (
            "-" + tag if tag else "")
    out = build_dir() / "variants" / (tag or "none") / f"{stem}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    _compile(_nvcc(), src or CSRC / f"{stem}.cu", out,
             tuple(f"-D{k}={v}" for k, v in sorted(defines.items())))
    return out


@contextlib.contextmanager
def use_library(stem: str, path: Path):
    """Within the block, the wrappers launch csrc/<stem>.cu's entry points
    from the library at `path` (from :func:`build_variant`) in place of the
    package's build."""
    def forget():
        for key in [k for k in _fns if k[0] == stem]:
            del _fns[key]

    old = _libs.get(stem)
    forget()
    _libs[stem] = ctypes.CDLL(str(path))
    try:
        yield
    finally:
        forget()
        if old is None:
            del _libs[stem]
        else:
            _libs[stem] = old


def ptxas_lines(log: Path) -> list[str]:
    """The ptxas -v lines of a build log that name a kernel and give its
    registers, stack and spills."""
    return [ln.split("info    : ")[-1].strip()
            for ln in log.read_text().splitlines()
            if "Function properties" in ln or "registers" in ln
            or "spill" in ln]


def ptxas_kernels(log: Path) -> list[dict]:
    """Each kernel of a build log with its ptxas -v figures: {"function"
    (the mangled name), "registers", "stack", "spill_stores",
    "spill_loads"} (bytes but registers)."""
    out, cur = [], None
    for ln in log.read_text().splitlines():
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            cur = {"function": m.group(1)}
            out.append(cur)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m and cur is not None:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
            continue
        m = re.search(r"Used (\d+) registers", ln)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
            cur = None
    return out


def tree_kernels(log: Path) -> dict:
    """Registers, stack and spills of each lane-tree kernel (merge.cuh's
    merge_kernel) in a build log, by branch: "g1" (FpField), "g2 pairs"
    (Fp2Pair), "g2" (the one-thread Fp2Field, the 8-limb SOS and SOS2);
    at 12 limbs with the branch's constant, "g1 b3=12", "g2 pairs nr=-5"
    and so on."""
    out = {}
    for k in ptxas_kernels(log):
        f = k.pop("function")
        m = re.search(r"(FpField|Fp2Pair|Fp2Field)ILi(\d+)ELi(n?)(\d+)E", f)
        if "merge_kernel" not in f or m is None:
            continue
        key = {"FpField": "g1", "Fp2Pair": "g2 pairs",
               "Fp2Field": "g2"}[m.group(1)]
        if m.group(2) != "8":
            c = int(m.group(4)) * (-1 if m.group(3) else 1)
            key += f" {'b3' if key == 'g1' else 'nr'}={c}"
        out[key] = k
    return out


def sass_opcodes(stem: str) -> dict[str, collections.Counter] | None:
    """{kernel symbol: Counter of its SASS opcodes} of the library built
    from csrc/<stem>.cu, read with the toolkit's cuobjdump; None where the
    toolkit has none."""
    tool = Path(_nvcc()).with_name("cuobjdump")
    if not tool.exists():
        return None
    r = subprocess.run([str(tool), "-sass", str(build_dir() / f"{stem}.so")],
                       capture_output=True, text=True, check=True)
    out: dict[str, collections.Counter] = {}
    cur = None
    for line in r.stdout.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = out.setdefault(m.group(1), collections.Counter())
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@\S+\s+)?([A-Z][A-Z0-9_.]*)",
                     line)
        if m and cur is not None:
            cur[m.group(1)] += 1
    return out


def library(stem: str) -> ctypes.CDLL:
    """The loaded library built from csrc/<stem>.cu (built on first use)."""
    lib = _libs.get(stem)
    if lib is None:
        path = build_dir() / f"{stem}.so"
        if not path.exists():
            build()
        lib = ctypes.CDLL(str(path))
        _libs[stem] = lib
    return lib


def function(stem: str, name: str, argtypes: list):
    """C entry point `name` of csrc/<stem>.cu with its argument types set
    (pointers and the stream as c_void_p, so none is cut to 32 bits); every
    entry point returns a CUDA error code."""
    key = (stem, name)
    fn = _fns.get(key)
    if fn is None:
        fn = getattr(library(stem), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[key] = fn
    return fn


def launch(fn, what: str, device: torch.device, *args) -> None:
    """Call the C entry point fn with `device` current (the caller's
    current device is restored after) and raise unless it returns 0."""
    with torch.cuda.device(device):
        rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def stream_ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def u32_array(vals) -> ctypes.Array:
    return (ctypes.c_uint32 * len(vals))(*vals)


def card_name_power() -> str:
    """The first card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them;
    raises if nvidia-smi fails."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True)
    return r.stdout.strip().splitlines()[0]


def env_report() -> dict:
    """Toolchain and card: torch's CUDA version, nvcc's version line, and
    the card's name and power limit as nvidia-smi reports them."""
    rep = {"torch": torch.__version__, "torch_cuda": torch.version.cuda,
           "nvcc": None, "gpu": None}
    try:
        r = subprocess.run([_nvcc(), "--version"], capture_output=True,
                           text=True)
        lines = [ln for ln in r.stdout.splitlines() if "release" in ln]
        rep["nvcc"] = lines[-1].strip() if lines else r.stdout.strip()
    except (RuntimeError, OSError) as e:
        rep["nvcc"] = f"unavailable: {e}"
    try:
        rep["gpu"] = card_name_power()
    except (OSError, subprocess.CalledProcessError, IndexError):
        rep["gpu"] = None
    return rep
