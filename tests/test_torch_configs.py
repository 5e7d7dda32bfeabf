"""The port's config dataclasses equal the reference's field for field:
names, defaults, and the derived paper configs (block shapes included)."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one intra-op thread, so parallel test workers do not
# oversubscribe the host
torch.set_num_threads(1)

from repro.configs import base as jbase, paper_models as jpm  # noqa: E402
from repro.core import prune_grow as jpg  # noqa: E402
from repro_torch.configs import base as tbase, paper_models as tpm  # noqa: E402
from repro_torch.core import prune_grow as tpg  # noqa: E402


def _fields(cls):
    out = []
    for f in dataclasses.fields(cls):
        if f.default is not dataclasses.MISSING:
            d = f.default
        elif f.default_factory is not dataclasses.MISSING:
            d = dataclasses.asdict(f.default_factory())
        else:
            d = dataclasses.MISSING
        out.append((f.name, d))
    return out


@pytest.mark.parametrize("pair", [(jbase.ModelConfig, tbase.ModelConfig),
                                  (jpg.BlastSpec, tpg.BlastSpec)],
                         ids=["ModelConfig", "BlastSpec"])
def test_field_names_and_defaults_match(pair):
    assert _fields(pair[0]) == _fields(pair[1])


@pytest.mark.parametrize("name", ["LLAMA32_1B", "LLAMA32_1B_SMOKE",
                                  "GPT2_SMALL", "GPT2_SMALL_SMOKE",
                                  "GPT2_XL"])
def test_paper_configs_match(name):
    j, t = getattr(jpm, name), getattr(tpm, name)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)


def test_llama_block_shapes():
    assert (tpm.LLAMA32_1B.blast.b_in, tpm.LLAMA32_1B.blast.b_out) == (128, 128)
    assert (tpm.LLAMA32_1B_SMOKE.blast.b_in,
            tpm.LLAMA32_1B_SMOKE.blast.b_out) == (16, 16)


@pytest.mark.parametrize("dims", [(2048, 8192, 16, True), (768, 3072, 16, True),
                                  (1600, 6400, 16, True), (64, 96, 1, False)])
def test_derive_block_shape_and_with_blast(dims):
    assert (jbase.derive_block_shape(*dims)
            == tbase.derive_block_shape(*dims))
    jc = jbase.ModelConfig(name="x", family="dense", num_layers=2,
                           d_model=dims[0], num_heads=4, num_kv_heads=2,
                           head_dim=16, d_ff=dims[1], vocab_size=64)
    tc = tbase.ModelConfig(**{f.name: getattr(jc, f.name)
                              for f in dataclasses.fields(jc)
                              if f.name != "blast"})
    assert (dataclasses.asdict(jbase.with_blast(jc, tp=dims[2]))
            == dataclasses.asdict(tbase.with_blast(tc, tp=dims[2])))


def test_init_scales_attention_weights_by_their_fan_in():
    """The port's seeded init draws every normal leaf with std
    scale / sqrt(fan-in), the fan-in being the size of the axes the
    weight contracts: d_model for wq/wk/wv, heads x head_dim for wo. The
    reference uses the second-to-last axis, a head axis for these 3-D
    weights (its wq std is 1/sqrt(num_heads)); its specs agree with the
    port's in shape and axes."""
    import math

    import jax

    from repro.models import registry as jreg
    from repro_torch.models import params as tparams, registry as treg

    cfg = tpm.LLAMA32_1B_SMOKE
    jspecs = jax.tree_util.tree_leaves(
        jreg.param_specs(jpm.LLAMA32_1B_SMOKE),
        is_leaf=lambda x: hasattr(x, "axes"))
    tspecs = [s for _, s in tparams._leaves(treg.param_specs(cfg))]
    assert [(s.shape, s.axes) for s in jspecs] == [
        (s.shape, s.axes) for s in tspecs]
    p = treg.init_params(cfg, 0, device="cpu")["layers"]
    d, h, hd = cfg.d_model, cfg.num_heads, cfg.head_dim
    down = 1.0 / math.sqrt(2 * cfg.num_layers)
    want = {"wq": 1 / math.sqrt(d), "wk": 1 / math.sqrt(d),
            "wv": 1 / math.sqrt(d), "wo": down / math.sqrt(h * hd)}
    for k, std in want.items():
        assert float(p["attn"][k].std()) == pytest.approx(std, rel=0.1), k
    assert float(p["mlp"]["w_gate"].std()) == pytest.approx(
        1 / math.sqrt(d), rel=0.1)
    jwq = jreg.init_params(jpm.LLAMA32_1B_SMOKE,
                           jax.random.PRNGKey(0))["layers"]["attn"]["wq"]
    assert float(jwq.std()) == pytest.approx(1 / math.sqrt(h), rel=0.1)
