"""What the ``tune_*`` scripts share: time kernel libraries under other
values of the macros their sources leave open to -D.

A script names the stems of its ``csrc/<stem>.cu`` (one or more), the
macros it may set (``tunables``), its default variants, its cases and how
to time one case, and hands its arguments to :func:`main`:

    python3 -m libff_tpu_torch.tune_X [--against DIR[:NAME=V,...]] ...
        [NAME=V,NAME=V ...] ...

Each ``NAME=V,...`` argument is one variant.  Each ``--against DIR`` adds
the ``csrc/<stem>.cu`` of another checkout at DIR (an earlier commit
unpacked with ``git archive``), built from its own sources, as one more
build; ``DIR:NAME=V,...`` builds it with those macros of its own sources
set (they are not checked against ``tunables``).  A build compiles every
stem, one nvcc each (``_build.build_variant``), all builds in parallel.
It prints each build's ptxas figures, then times every case under the
package's build and each other build, in ``passes`` passes, and holds
each build's outputs against the package build's (which the script's
cases hold against their plain versions).  It prints one JSON line per
pass, case and build, then the card's name and power limit.  It needs a
CUDA card and refuses to run without one.
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


def split_args(argv: list[str], tunables: Iterable[str],
               stem: str) -> tuple[list, list]:
    """([(DIR, {macro: value})] of the ``--against`` arguments, [{macro:
    value}] of the variants) of a script's arguments."""
    against, variants = [], []
    it = iter(argv)
    for a in it:
        if a == "--against":
            where, _, consts = next(it).partition(":")
            against.append((Path(where), {k: int(v) for k, v in (
                kv.split("=") for kv in consts.split(",") if kv)}))
        else:
            variants.append(parse(a, tunables, stem))
    return against, variants


def main(prog: str, stem: str | tuple[str, ...], tunables: Iterable[str],
         argv: list[str], defaults: list[dict], cases: Callable,
         measure: Callable, passes: int = 1,
         ptxas: Callable = _build.ptxas_kernels) -> int:
    """`stem`: the source or sources a build compiles.  `cases(device)`
    yields (label, case, want): a dict that names the case in each JSON
    line, what `measure` takes, and the package build's outputs as a list
    of tensors.  `measure(case, rep)` times the case in pass `rep` and
    returns (a dict of its times, the outputs as a list of tensors).
    `ptxas(log)` reads a build log's figures."""
    if not torch.cuda.is_available():
        print(f"{prog}: needs a CUDA card", file=sys.stderr)
        return 2
    stems = (stem,) if isinstance(stem, str) else tuple(stem)
    against, variants = split_args(argv, tunables, stems[0])
    variants = variants or defaults
    _build.build()
    jobs = [("variant", v, s, v, None) for v in variants for s in stems]
    jobs += [("against", f"{where}" + (f":{consts}" if consts else ""), s,
              consts, where / f"libff_tpu_torch/csrc/{s}.cu")
             for where, consts in against for s in stems]
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as ex:
        libs = list(ex.map(lambda j: _build.build_variant(*j[2:]), jobs))
    builds = [("build", None, {s: None for s in stems})]
    for (kind, label, s, _, _), lib in zip(jobs, libs):
        if builds[-1][:2] != (kind, label):
            builds.append((kind, label, {}))
        builds[-1][2][s] = lib
    for kind, label, lib in builds:
        for s in stems:
            log = (lib[s] or _build.build_dir() / f"{s}.so").with_suffix(
                ".log")
            print(json.dumps({kind: label, "stem": s, "ptxas": ptxas(log)}),
                  flush=True)
    todo = cases(torch.device("cuda", 0))
    if passes > 1:
        todo = list(todo)
    for rep in range(passes):
        for label, case, want in todo:
            for kind, consts, lib in builds:
                with contextlib.ExitStack() as stack:
                    for s, path in lib.items():
                        if path is not None:
                            stack.enter_context(_build.use_library(s, path))
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
