"""What the ``tune_*`` scripts share: time one kernel library under other
values of the macros its source leaves open to -D.

A script names the stem of its ``csrc/<stem>.cu``, the macros it may set
(``tunables``), its default variants, its cases and how to time one case,
and hands its arguments to :func:`main`:

    python3 -m libff_tpu_torch.tune_X [--against DIR]
        [NAME=V,NAME=V ...] ...

Each ``NAME=V,...`` argument is one variant.  ``--against DIR`` adds the
``csrc/<stem>.cu`` of another checkout at DIR (an earlier commit unpacked
with ``git archive``), built from its own sources, as one more build.
The variants are built by one nvcc each (``_build.build_variant``), all
in parallel.  It prints each build's ptxas figures, then times every case
under the package's build and each other build, in ``passes`` passes,
and holds each build's outputs against the package build's (which the
script's cases hold against their plain versions).  It prints one JSON
line per pass, case and build, then the card's name and power limit.  It
needs a CUDA card and refuses to run without one.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import json
import sys
from pathlib import Path
from typing import Callable, Iterable

import torch

from . import _build


def parse(arg: str, tunables: Iterable[str], stem: str) -> dict:
    """{macro: value} of one ``NAME=V,NAME=V`` argument; raises on a macro
    that is not in `tunables`."""
    out = {k: int(v) for k, v in (kv.split("=") for kv in arg.split(","))}
    unknown = set(out) - set(tunables)
    if unknown:
        raise ValueError(f"not a macro of {stem}: {sorted(unknown)}")
    return out


def main(prog: str, stem: str, tunables: Iterable[str], argv: list[str],
         defaults: list[dict], cases: Callable, measure: Callable,
         passes: int = 1, ptxas: Callable = _build.ptxas_kernels) -> int:
    """`cases(device)` yields (label, case, want): a dict that names the
    case in each JSON line, what `measure` takes, and the package build's
    outputs as a list of tensors.  `measure(case, rep)` times the case in
    pass `rep` and returns (a dict of its times, the outputs as a list
    of tensors).  `ptxas(log)` reads a build log's figures."""
    if not torch.cuda.is_available():
        print(f"{prog}: needs a CUDA card", file=sys.stderr)
        return 2
    against = None
    if argv[:1] == ["--against"]:
        against, argv = Path(argv[1]), argv[2:]
    variants = [parse(a, tunables, stem) for a in argv] or defaults
    _build.build()
    jobs = [("variant", v, v, None) for v in variants]
    if against is not None:
        jobs.append(("against", str(against), {},
                     against / f"libff_tpu_torch/csrc/{stem}.cu"))
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as ex:
        libs = list(ex.map(lambda j: _build.build_variant(stem, *j[2:]),
                           jobs))
    builds = [("build", None, None)] + [
        (kind, consts, lib) for (kind, consts, _, _), lib in zip(jobs, libs)]
    for kind, consts, lib in builds:
        log = (lib or _build.build_dir() / f"{stem}.so").with_suffix(".log")
        print(json.dumps({kind: consts, "ptxas": ptxas(log)}), flush=True)
    todo = cases(torch.device("cuda", 0))
    if passes > 1:
        todo = list(todo)
    for rep in range(passes):
        for label, case, want in todo:
            for kind, consts, lib in builds:
                with (contextlib.nullcontext() if lib is None
                      else _build.use_library(stem, lib)):
                    times, got = measure(case, rep)
                equal = len(got) == len(want) and all(
                    torch.equal(a, b) for a, b in zip(got, want))
                print(json.dumps({**label, "pass": rep, kind: consts,
                                  "equal_to_build": equal, **times}),
                      flush=True)
                if not equal:
                    raise RuntimeError(f"{kind} {consts} gives other "
                                       f"outputs on {label}")
    print(_build.card_name_power(), flush=True)
    return 0
