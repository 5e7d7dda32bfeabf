"""The reference's small public names that the port carries too, each
against the reference on the same inputs: ``ModelConfig.n_params`` /
``n_active_params``, ``models/layers.py::remat_policy``,
``configs/paper_models.py::LLAMA_FAMILY_MLP``,
``core/topk.py::mask_sparsity``, ``BlastSpec.block_grid``,
``kernels/bspmm_t.py::first_visit_flags`` and ``Engine(offload_store=)``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import _torch_serving as ts  # noqa: E402
from conftest import tiny_cfg  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.configs import paper_models as jpm  # noqa: E402
from repro.core import topk as jtopk  # noqa: E402
from repro.core.prune_grow import BlastSpec as JBlast  # noqa: E402
from repro.kernels import bspmm_t as jbt  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.serving.offload import HostKVStore as JStore  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.configs import paper_models as tpm  # noqa: E402
from repro_torch.core import topk as ttopk  # noqa: E402
from repro_torch.core.prune_grow import BlastSpec as TBlast  # noqa: E402
from repro_torch.kernels import bspmm_t as tbt  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.serving.offload import HostKVStore as TStore  # noqa: E402
from test_torch_transformer import port_cfg  # noqa: E402

ARCHS = ("stablelm-3b", "qwen2-7b", "gemma2-27b", "deepseek-moe-16b",
         "qwen3-moe-235b-a22b", "rwkv6-3b", "zamba2-1.2b",
         "whisper-large-v3", "internvl2-2b")
POLICIES = ("nothing_saveable", "dots_saveable",
            "dots_with_no_batch_dims_saveable")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("smoke", [False, True])
def test_param_counts_equal_reference(arch, smoke):
    j, t = jget(arch, smoke=smoke), tget(arch, smoke=smoke)
    assert t.n_params() == j.n_params()
    assert t.n_active_params() == j.n_active_params()
    if t.is_moe:
        assert t.n_active_params() < t.n_params()
    else:
        assert t.n_active_params() == t.n_params()


def test_llama_family_mlp_equals_reference():
    assert tpm.LLAMA_FAMILY_MLP == jpm.LLAMA_FAMILY_MLP
    d, f = tpm.LLAMA_FAMILY_MLP["llama3.2-1b"]
    assert (d, f) == (tpm.LLAMA32_1B.d_model, tpm.LLAMA32_1B.d_ff)


@pytest.mark.parametrize("policy", POLICIES + ("no_such_policy",))
def test_remat_policy_names(policy):
    """The reference's three names resolve in both packages (the port's
    ``nothing_saveable`` is plain recomputation, None); an unknown one
    raises KeyError in both."""
    jcfg = tiny_cfg(remat_policy=policy)
    tcfg = port_cfg(jcfg)
    if policy not in POLICIES:
        with pytest.raises(KeyError):
            jlayers.remat_policy(jcfg)
        with pytest.raises(KeyError):
            tlayers.remat_policy(tcfg)
        return
    assert jlayers.remat_policy(jcfg) is not None
    got = tlayers.remat_policy(tcfg)
    assert (got is None) == (policy == "nothing_saveable")


@pytest.mark.parametrize("policy", POLICIES)
def test_remat_policy_changes_memory_not_numbers(policy):
    """A training forward and backward under each policy gives the
    gradients of the forward without remat, bitwise; the saving policies
    keep matmul outputs (recomputing fewer of them in the backward)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.models import registry, transformer
    base = port_cfg(tiny_cfg(remat=False, num_layers=2))
    params = registry.init_params(base, 0, device="cpu")
    tokens = torch.randint(0, base.vocab_size, (2, 8),
                           generator=torch.Generator().manual_seed(0))

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func in (torch.ops.aten.mm.default,
                        torch.ops.aten.bmm.default):
                Count.n += 1
            return func(*args, **(kwargs or {}))

    def grads(cfg):
        tree = tadamw.tree_map(lambda p: p.detach().requires_grad_(),
                               params)
        Count.n = 0
        with Count():
            logits, _ = transformer.forward(cfg, tree, tokens)
            logits.sum().backward()
        return [p.grad for p in tadamw.tree_leaves(tree)], Count.n

    want, n_plain = grads(base)
    got, n = grads(dataclasses.replace(base, remat=True,
                                       remat_policy=policy))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    if policy == "nothing_saveable":
        assert n > n_plain          # every layer's products recomputed
    else:
        assert n_plain <= n < grads(dataclasses.replace(
            base, remat=True, remat_policy="nothing_saveable"))[1]


def test_mask_sparsity_equals_reference():
    rng = np.random.default_rng(0)
    for shape, p in (((4, 8), 0.3), ((2, 3, 5, 7), 0.7), ((6, 6), 1.0),
                     ((6, 6), 0.0)):
        m = rng.random(shape) < p
        got = float(ttopk.mask_sparsity(torch.as_tensor(m)))
        want = float(jtopk.mask_sparsity(jnp.asarray(m)))
        assert got == pytest.approx(want, abs=1e-7)
        assert got == pytest.approx(1.0 - m.mean(), abs=1e-7)


@pytest.mark.parametrize("b_in,b_out", [(16, 16), (128, 128), (16, 64)])
def test_block_grid_equals_reference(b_in, b_out):
    j, t = JBlast(b_in=b_in, b_out=b_out), TBlast(b_in=b_in, b_out=b_out)
    for k, n in ((128, 256), (2048, 8192), (512, 128)):
        assert t.block_grid(k, n) == j.block_grid(k, n)
    with pytest.raises(AssertionError):
        j.block_grid(b_in + 1, b_out)
    with pytest.raises(ValueError):
        t.block_grid(b_in + 1, b_out)


@pytest.mark.parametrize("seed", range(4))
def test_first_visit_flags_equal_reference(seed):
    rng = np.random.default_rng(seed)
    kb = int(rng.integers(2, 12))
    nb, nnz = int(rng.integers(1, 9)), int(rng.integers(1, kb + 1))
    idx = np.stack([rng.choice(kb, nnz, replace=False)
                    for _ in range(nb)]).astype(np.int32)
    want = jbt.first_visit_flags(idx, kb)
    got = tbt.first_visit_flags(torch.as_tensor(idx), kb)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    # every block-row visited is flagged exactly once
    assert got.sum() == len(np.unique(idx))
    with pytest.raises(ValueError):
        tbt.first_visit_flags(idx, int(idx.max()))


def test_engine_offload_store_is_used():
    """Both engines offload into the store they are given: a forced
    preemption leaves its record there, it comes back from there, and
    the two stores saw the same peak bytes."""
    model = ts.build("tiny")
    jstore, tstore = JStore(1 << 20), TStore(1 << 20)
    je, te = ts.engines(model, preempt=True,
                        jkw={"offload_store": jstore},
                        tkw={"offload_store": tstore})
    assert je._offload is jstore and te._offload is tstore
    ps = ts.prompts(model[0].vocab_size, (7, 5, 9))
    for p in ps:
        assert je.submit(p, 12) == te.submit(p, 12)
    held = {}

    def hook(n, je, te):
        i = ts.live_lane_of(je, 0)
        if held or i is None:
            return
        je.preempt(i)
        te.preempt(i)
        held["j"], held["t"] = len(jstore), len(tstore)

    out, _, _ = ts.lockstep(je, te, hook)
    ts.check_results(model, *out)
    assert held == {"j": 1, "t": 1}
    assert len(jstore) == len(tstore) == 0
    assert tstore.bytes_peak == jstore.bytes_peak > 0
    assert te.stats["offload_bytes_peak"] == tstore.bytes_peak
