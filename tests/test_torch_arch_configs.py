"""The port's ``--arch`` registry equals the reference's: every one of the
ten configs and its smoke variant field by field (the BLaST spec and its
derived block shape included), the ids, shapes, skips and dry-run cells,
the error on an unknown id, and the parameter counts of the four dense,
the two recurrent and the two MoE models at full size (from the spec
trees, nothing allocated), with the modules and serving flags of the MoE,
recurrent, ``audio`` and ``vlm`` families."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one intra-op thread, so parallel test workers do not
# oversubscribe the host
torch.set_num_threads(1)

from repro import configs as jconfigs  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402

DENSE = ("stablelm-3b", "stablelm-12b", "qwen2-7b", "gemma2-27b")
MOE = ("qwen3-moe-235b-a22b", "deepseek-moe-16b")
RECURRENT = ("rwkv6-3b", "zamba2-1.2b")
AUDIO_VLM = ("whisper-large-v3", "internvl2-2b")


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_config_matches_reference(arch, smoke):
    j = jconfigs.get_config(arch, smoke=smoke)
    t = tconfigs.get_config(arch, smoke=smoke)
    assert type(t).__module__.startswith("repro_torch.")
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


def test_ids_shapes_skips_and_cells_match():
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    assert ({k: dataclasses.asdict(v) for k, v in tconfigs.SHAPES.items()}
            == {k: dataclasses.asdict(v)
                for k, v in jconfigs.SHAPES.items()})
    for arch in jconfigs.ARCH_IDS:
        assert tconfigs.skip_shapes(arch) == jconfigs.skip_shapes(arch)
    assert tconfigs.cells() == jconfigs.cells()
    assert tconfigs.cells(True) == jconfigs.cells(True)
    assert len(tconfigs.cells(True)) == 4 * len(tconfigs.ARCH_IDS)


def test_unknown_arch_raises_key_error():
    for mod in (jconfigs, tconfigs):
        with pytest.raises(KeyError, match="unknown arch"):
            mod.get_config("llama-9000")
        with pytest.raises(KeyError):
            mod.skip_shapes("llama-9000")


@pytest.mark.parametrize("arch", AUDIO_VLM)
def test_families_not_ported_raise_at_module_for(arch):
    """``module_for`` answers whisper for ``audio`` and the transformer for
    ``vlm``, as the reference's does; the engine serves the VLM (text
    only) and refuses whisper, whose flags are all false there too."""
    for smoke in (False, True):
        t = tconfigs.get_config(arch, smoke=smoke)
        j = jconfigs.get_config(arch, smoke=smoke)
        mod = {"audio": "whisper", "vlm": "transformer"}[t.family]
        assert treg.module_for(t).__name__ == f"repro_torch.models.{mod}"
        assert jreg.module_for(j).__name__ == f"repro.models.{mod}"
        for fn in ("supports_prefill_chunk", "supports_paged",
                   "supports_mixed"):
            assert getattr(treg, fn)(t) == getattr(jreg, fn)(j) == (
                t.family == "vlm")


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_families_are_ported(arch):
    """``module_for`` answers rwkv6 for ``ssm`` and zamba for ``hybrid``;
    neither is servable by the engine, as in the reference."""
    for smoke in (False, True):
        t = tconfigs.get_config(arch, smoke=smoke)
        j = jconfigs.get_config(arch, smoke=smoke)
        mod = {"ssm": "rwkv6", "hybrid": "zamba"}[t.family]
        assert treg.module_for(t).__name__ == f"repro_torch.models.{mod}"
        for fn in ("supports_prefill_chunk", "supports_paged",
                   "supports_mixed"):
            assert getattr(treg, fn)(t) == getattr(jreg, fn)(j) is False


@pytest.mark.parametrize("arch", DENSE + RECURRENT)
def test_dense_param_counts_match_reference(arch):
    t = tconfigs.get_config(arch)
    j = jconfigs.get_config(arch)
    assert t.family in ("dense", "ssm", "hybrid")
    total = treg.count_params(t)
    assert total == jreg.count_params(j)
    assert treg.count_params(t, active_only=True) == jreg.count_params(
        j, active_only=True) == total


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", MOE)
def test_moe_family_is_ported(arch, smoke):
    """``module_for`` answers for the MoE ids, and the serving flags are
    the reference's."""
    t = tconfigs.get_config(arch, smoke=smoke)
    j = jconfigs.get_config(arch, smoke=smoke)
    assert t.family == "moe"
    assert treg.module_for(t).__name__ == "repro_torch.models.transformer"
    for fn in ("supports_prefill_chunk", "supports_paged",
               "supports_mixed"):
        assert getattr(treg, fn)(t) == getattr(jreg, fn)(j), fn


@pytest.mark.parametrize("arch", MOE)
def test_moe_param_counts_match_reference(arch):
    """Total and active (top_k of the experts) counts at full size."""
    t = tconfigs.get_config(arch)
    j = jconfigs.get_config(arch)
    for active in (False, True):
        assert treg.count_params(t, active_only=active) == jreg.count_params(
            j, active_only=active)
    assert treg.count_params(t, active_only=True) < treg.count_params(t)
