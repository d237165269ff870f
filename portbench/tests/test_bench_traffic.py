"""The generator: deterministic in the seed, the samplers' shapes."""

import pytest
import torch

from portbench import registry
from portbench.traffic import generator

BIG_SEED = 2 ** 31 + 12345


def _pool(root, cell, seed):
    spec = registry.cell(cell, root)
    cfg = registry.config(spec["config"], root)
    mix = registry.traffic(spec["traffic"], root)
    calls = generator.pool(cfg, mix, seed, "cpu", torch.float64, root)
    return calls, cfg, mix


@pytest.mark.parametrize("cell", ["markowitz.book1024x500",
                                  "dense4352.condensed"])
def test_same_seed_same_calls(tiny_root, cell):
    a, _, _ = _pool(tiny_root, cell, BIG_SEED)
    b, _, _ = _pool(tiny_root, cell, BIG_SEED)
    c, _, _ = _pool(tiny_root, cell, BIG_SEED + 1)
    for ca, cb, cc in zip(a, b, c):
        assert torch.equal(ca.x0, cb.x0)
        assert all(torch.equal(u, v) for u, v in zip(ca.params, cb.params))
        assert not torch.equal(ca.params[0], cc.params[0])
    # the pool's calls differ from one another
    assert not torch.equal(a[0].params[0], a[1].params[0])


def test_book_shapes_and_law(tiny_root):
    pool, cfg, mix = _pool(tiny_root, "markowitz.book1024x500", BIG_SEED)
    B, D = mix["batch"], mix["sizes"]["nassets"]
    assert len(pool) == mix["pool"]
    S, m, gamma, cap = pool[0].params
    assert S.shape == (B, D, D) and m.shape == (B, D)
    assert gamma.shape == (B,) and cap.shape == (B, D)
    assert torch.equal(S, S.transpose(1, 2))
    assert torch.linalg.eigvalsh(S).min() >= 0.05 - 1e-12
    assert bool((gamma >= 0.5).all())
    assert torch.allclose(cap, torch.full_like(cap, 4.0 / D))
    assert pool[0].x0.shape == (B, D)
    assert torch.allclose(pool[0].x0.sum(-1), torch.ones(B,
                                                         dtype=S.dtype))


def test_dense_shapes_and_law(tiny_root):
    pool, cfg, mix = _pool(tiny_root, "dense4352.ldlt", BIG_SEED)
    D, M, H = (cfg["sizes"][k] for k in ("nvar", "neq", "hidden"))
    assert len(pool) == mix["pool"]
    P, c, W, Aeq, beq, alpha = pool[0].params
    assert P.shape == (D, D) and c.shape == (D,) and W.shape == (H, D)
    assert Aeq.shape == (M, D) and beq.shape == (M,) and alpha.shape == ()
    assert torch.equal(P, P.T)
    assert torch.linalg.eigvalsh(P).min() >= 0.5 - 1e-12
    assert pool[0].x0.shape == (D,)
    assert torch.all(pool[0].x0 == 1e-3)


def test_committed_sizes():
    """The committed mixes and configurations are the cells' real sizes."""
    assert registry.traffic("book1024x500")["batch"] == 1024
    assert registry.traffic("book1024x500")["sizes"] == {"nassets": 500}
    assert registry.config("dense4352")["sizes"] == {
        "nvar": 4096, "neq": 256, "hidden": 256}
    for name in ("markowitz", "dense4352"):
        assert registry.config(name)["float_dtype"] == "float64"
