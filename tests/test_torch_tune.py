"""The shared harness of the tuning scripts, ``libff_tpu_torch.tune``: each
script's macros parse and an unknown one is refused, and every script
refuses to run without a card (it builds and times only on one)."""

import importlib

import pytest
import torch

from libff_tpu_torch import tune

SCRIPTS = ("tune_insert", "tune_group_ops", "tune_merge")


def _script(name):
    return importlib.import_module(f"libff_tpu_torch.{name}")


@pytest.mark.parametrize("name", SCRIPTS)
def test_tune_parse_takes_the_scripts_macros_and_refuses_others(name):
    m = _script(name)
    arg = ",".join(f"{k}={i + 2}" for i, k in enumerate(m.TUNABLES))
    assert tune.parse(arg, m.TUNABLES, name) == {
        k: i + 2 for i, k in enumerate(m.TUNABLES)}
    with pytest.raises(ValueError, match="LFF_NOT_A_MACRO"):
        tune.parse("LFF_NOT_A_MACRO=1", m.TUNABLES, name)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
@pytest.mark.parametrize("name", SCRIPTS)
def test_tune_script_refuses_without_a_card(name, capsys):
    assert _script(name).main([]) == 2
    assert "needs a CUDA card" in capsys.readouterr().err


def test_tune_split_args_reads_against_builds_and_variants():
    """``--against DIR`` and ``--against DIR:NAME=V,...`` (another
    checkout's macros, not checked) beside the script's own variants."""
    m = _script("tune_insert")
    against, variants = tune.split_args(
        ["--against", "_tree/parent", "LFF_SORT_WARPS=4",
         "--against", "_tree/parent:LFF_MIN_BLOCKS_G1=3,LFF_OLD=2"],
        m.TUNABLES, "insert")
    assert [(str(p), c) for p, c in against] == [
        ("_tree/parent", {}),
        ("_tree/parent", {"LFF_MIN_BLOCKS_G1": 3, "LFF_OLD": 2})]
    assert variants == [{"LFF_SORT_WARPS": 4}]
