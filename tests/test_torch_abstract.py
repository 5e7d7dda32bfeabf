"""Shapes and dtypes without allocation, against the reference's:
``registry.abstract_cache`` for the recurrent and audio families (which
lacked it) and the transformer, and ``training/step.py::abstract_state``
(the train state's logical layout, which ``sharding.train_specs`` builds
the sharded state from)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.training import step as jts  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.models import registry as treg  # noqa: E402
from repro_torch.training import step as tts  # noqa: E402


def _same(port, ref):
    """An ``AbstractParam`` against a ``ShapeDtypeStruct``."""
    assert tuple(port.shape) == tuple(ref.shape)
    assert str(port.dtype).removeprefix("torch.") == np.dtype(ref.dtype).name


def _zip(port: dict, ref: dict):
    assert sorted(port) == sorted(ref)
    for k in ref:
        if isinstance(ref[k], dict):
            _zip(port[k], ref[k])
        else:
            _same(port[k], ref[k])


@pytest.mark.parametrize("arch", ["rwkv6-3b", "zamba2-1.2b",
                                  "whisper-large-v3", "llama3.2-1b"])
@pytest.mark.parametrize("batch,max_len", [(2, 16), (3, 40)])
def test_abstract_cache_matches_reference(arch, batch, max_len):
    if arch == "llama3.2-1b":
        from repro.configs.paper_models import LLAMA32_1B as jcfg
        from repro_torch.configs.paper_models import LLAMA32_1B as tcfg
    else:
        jcfg, tcfg = jget(arch), tget(arch)
    _zip(treg.abstract_cache(tcfg, batch, max_len),
         jreg.abstract_cache(jcfg, batch, max_len))


def test_whisper_abstract_cache_takes_the_encoder_length():
    ref = jreg.abstract_cache(jget("whisper-large-v3"), 2, 16, enc_len=1500)
    _zip(treg.abstract_cache(tget("whisper-large-v3"), 2, 16, enc_len=1500),
         ref)
    assert ref["ck"].shape[2] == 1500


@pytest.mark.parametrize("arch", ["stablelm-3b", "gemma2-27b",
                                  "deepseek-moe-16b", "rwkv6-3b",
                                  "zamba2-1.2b", "whisper-large-v3"])
def test_abstract_state_matches_reference(arch):
    """Params, both moments, the masks and the step, leaf by leaf."""
    j, t = jts.abstract_state(jget(arch)), tts.abstract_state(tget(arch))
    _zip(t.params, j.params)
    for k in ("m", "v"):
        _zip(t.opt_state[k], j.opt_state[k])
    _zip(t.masks, dict(j.masks))
    _same(t.step, j.step)
    assert t.generator is None


def test_abstract_state_without_blast_has_no_masks():
    cfg = tget("stablelm-3b")
    cfg = dataclasses.replace(cfg, blast=dataclasses.replace(
        cfg.blast, enabled=False))
    assert tts.abstract_state(cfg).masks == {}
    jcfg = jget("stablelm-3b")
    jcfg = dataclasses.replace(jcfg, blast=dataclasses.replace(
        jcfg.blast, enabled=False))
    assert dict(jts.abstract_state(jcfg).masks) == {}
    assert jax.tree_util.tree_leaves(jts.abstract_state(jcfg).masks) == []
