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
