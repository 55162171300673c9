"""The port's sharded calibration (``parallel/``) on the CPU: the twin of
tests/test_parallel.py.

The port's mesh is a ``torch.distributed`` group; in this process it is a
one-rank gloo group (``make_mesh(1, device_type="cpu")``), and layouts of
several ranks run as subprocesses (``tools/dist_check.py``).

Bars:
  * sharded against unsharded, within the port at float64: equal bits. A
    rank runs ``calibrate_batch`` on its contiguous rows (edge-padded), and
    the batched L-BFGS's lanes are independent: every plain op on the CPU
    path is per lane (sums over a lane's 13 parameters or its options), so
    no reduction order moves with the lane count, and a shard's winners
    equal the full batch's rows bit for bit. The test holds that for the
    shards of 2 ranks (with the edge-padding row) and for the one-rank
    mesh, and 4 ranks against 1 on 5 surfaces (the last rank holds only
    padding);
  * the summary against a host recomputation from the gathered winners:
    rtol 1e-12 (float64 sums in another order);
  * against JAX (``calibrate_sharded`` on the 8-device virtual mesh, the
    same starts injected): outcome level, as ROADMAP Queue 3 records for
    the slice. Both converge (loss < 1e-4), equal ``n_total``, both mean
    relative errors below 1e-3; the prices from the starts off the Feller
    kink within 2e-4 relative (the test's docstring says why start 0 is
    not compared).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from option_pricing_ffn_lbfgs_tpu.calibration.initial_guess import (
    initial_guesses as jax_initial_guesses)
from option_pricing_ffn_lbfgs_tpu.calibration.transforms import (
    transform as jax_transform)
from option_pricing_ffn_lbfgs_tpu.models.double_heston import (
    DHParams, price_options)
from option_pricing_ffn_lbfgs_tpu.parallel.mesh import make_mesh as jax_mesh
from option_pricing_ffn_lbfgs_tpu.parallel.sharded import (
    calibrate_sharded as jax_sharded)
from option_pricing_ffn_lbfgs_tpu.utils.config import (
    CalibrationConfig as JConfig, LBFGSConfig as JLBFGS)
import option_pricing_ffn_lbfgs_tpu_torch as port
from option_pricing_ffn_lbfgs_tpu_torch.parallel.mesh import (
    SURFACE_AXIS, batch_sharding, pad_to_multiple, replicated_sharding)
from option_pricing_ffn_lbfgs_tpu_torch.parallel.sharded import (
    ShardedSummary)
from option_pricing_ffn_lbfgs_tpu_torch.tools import dist_check
from option_pricing_ffn_lbfgs_tpu_torch.utils.config import (
    CalibrationConfig, LBFGSConfig, PricerConfig)
from tests.conftest import TRUE

FAST = CalibrationConfig(lbfgs=LBFGSConfig(maxiter=25))
# The bit-identity test's config: N = 32 keeps its four calibrations short.
FAST32 = CalibrationConfig(pricer=PricerConfig(n_terms=32),
                           lbfgs=LBFGSConfig(maxiter=25))
CPU = torch.device("cpu")
F64 = torch.float64


def _batch(b, surface15):
    """tests/test_parallel.py's batch: B surfaces with slightly different
    true params and spots, float64 prices from JAX, and per-surface keys;
    as numpy arrays."""
    strikes, mats, is_call = surface15
    rng = np.random.default_rng(0)
    spots = jnp.asarray(100.0 + rng.uniform(-2, 2, b))
    base = np.array([TRUE[k] for k in
                     DHParams.from_dict(TRUE, jnp.float64)._fields])
    vecs = jnp.asarray(base * (1.0 + rng.uniform(-0.05, 0.05, (b, 13))))
    prices = jax.vmap(
        lambda s, v: price_options(DHParams.from_vector(v), s, 0.03,
                                   strikes, mats, is_call))(spots, vecs)
    bs = jnp.broadcast_to(strikes, (b, 15))
    bm = jnp.broadcast_to(mats, (b, 15))
    bc = jnp.broadcast_to(is_call, (b, 15))
    keys = jax.random.split(jax.random.key(0), b)
    return spots, bs, bm, bc, prices, keys


def _np(*a):
    return tuple(np.asarray(x) for x in a)


@pytest.fixture(scope="module")
def mesh():
    return port.make_mesh(1, device_type="cpu")


def _assert_same_bits(a, b):
    for f in port.BatchCalibration._fields:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        assert torch.equal(x, y), f


def test_pad_to_multiple():
    assert pad_to_multiple(5, 8) == 8
    assert pad_to_multiple(8, 8) == 8
    assert pad_to_multiple(9, 8) == 16


def test_make_mesh_one_rank(mesh):
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard
    assert mesh.size() == 1 and mesh.ndim == 1
    assert mesh.mesh_dim_names == (SURFACE_AXIS,) == ("surfaces",)
    assert mesh.device_type == "cpu"
    assert dist.get_backend(mesh.get_group()) == "gloo"
    assert port.make_mesh(device_type="cpu").size() == 1
    assert batch_sharding(mesh) == [Shard(0)]
    assert replicated_sharding(mesh) == [Replicate()]
    with pytest.raises(ValueError):
        port.make_mesh(2, device_type="cpu")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["float32", "float64"])
def test_batchnorm_one_rank_group_equals_no_group(mesh, dtype):
    """The train-mode BatchNorm over a one-rank group: the same output,
    running statistics and gradients as with no group, in bits."""
    from option_pricing_ffn_lbfgs_tpu_torch.surrogate.ffn import (
        init_ffn, use_process_group)
    rng = np.random.default_rng(6)
    x = torch.tensor(rng.normal(size=(16, 11)), dtype=dtype)
    y = torch.tensor(rng.normal(size=(16, 13)), dtype=dtype)
    runs = []
    for group in (None, mesh.get_group()):
        model = init_ffn(torch.Generator().manual_seed(2)).to(dtype)
        use_process_group(model, group).train()
        out = model(x, torch.Generator().manual_seed(3))
        torch.mean((out - y) ** 2).backward()
        runs.append((out.detach(), model.state_dict(),
                     {n: p.grad for n, p in model.named_parameters()}))
    (out0, sd0, g0), (out1, sd1, g1) = runs
    assert torch.equal(out0, out1)
    assert sd0.keys() == sd1.keys() and g0.keys() == g1.keys()
    for k in sd0:
        assert torch.equal(sd0[k], sd1[k]), k
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k


@pytest.mark.parametrize("device_type,world,local,want", [
    ("cpu", 2, None, "gloo"),
    ("cuda", 1, None, "nccl"),
    ("cuda", 2, "2", "gloo"),        # two ranks share the host's one card
    ("cuda", 4, "1", "nccl"),        # four hosts, a rank and a card each
    ("cuda", 2, None, RuntimeError),  # ranks per host unknown
])
def test_choose_backend(monkeypatch, device_type, world, local, want):
    from option_pricing_ffn_lbfgs_tpu_torch.parallel.mesh import (
        choose_backend)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    if local is None:
        monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    else:
        monkeypatch.setenv("LOCAL_WORLD_SIZE", local)
    if want is RuntimeError:
        with pytest.raises(RuntimeError, match="LOCAL_WORLD_SIZE"):
            choose_backend(device_type, world)
    else:
        assert choose_backend(device_type, world) == want


def test_sharded_matches_unsharded_bits(mesh, surface15):
    """The one-rank mesh, and the two shards of a 2-rank mesh (7 surfaces:
    rows 0-3 and 4-6 plus an edge-padding copy of row 6), equal the
    unsharded calibrate_batch bit for bit."""
    spots, bs, bm, bc, prices = _np(*_batch(7, surface15)[:5])
    x0 = port.initial_guesses(
        2, torch.Generator().manual_seed(3), *(torch.tensor(a) for a in
                                               (spots, bs, bm, prices)))
    run = lambda rows: port.calibrate_batch(
        spots[rows], 0.03, bs[rows], bm[rows], bc[rows], prices[rows],
        config=FAST32, n_starts=2, x0=x0[rows], device=CPU, dtype=F64)
    full = run(np.arange(7))
    out, summary = port.calibrate_sharded(
        mesh, spots, 0.03, bs, bm, bc, prices, config=FAST32, n_starts=2,
        x0=x0, device=CPU, dtype=F64)
    _assert_same_bits(out, full)
    assert isinstance(summary, ShardedSummary) and int(summary.n_total) == 7
    for rows in (np.arange(4), np.array([4, 5, 6, 6])):
        shard = run(rows)
        _assert_same_bits(shard, port.BatchCalibration(
            *(getattr(full, f)[rows] for f in port.BatchCalibration._fields)))
    # the generator route draws the same starts as calibrate_batch
    g_out, _ = port.calibrate_sharded(
        mesh, spots, 0.03, bs, bm, bc, prices,
        torch.Generator().manual_seed(3), FAST32, n_starts=2, device=CPU,
        dtype=F64)
    _assert_same_bits(g_out, full)


def test_sharded_uneven_batch_four_ranks():
    """B = 5 over 4 gloo ranks (padded to 8; the last rank holds padding
    only): n_total 5, and the gathered winners equal a one-rank run's in
    bits."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    four = dist_check.launch(4, "cpu", "tiny5", env=env)
    one = dist_check.launch(1, "cpu", "tiny5", env=env)
    for line in four:
        assert line["summary"]["n_total"] == 5
        assert len(line["loss"]) == 5
        assert line["winners_sha256"] == one[0]["winners_sha256"]
        assert line["summary"] == one[0]["summary"]
    assert np.isfinite(four[0]["summary"]["mean_rel_error"])


def test_sharded_summary_matches_host(mesh, surface15):
    spots, bs, bm, bc, prices = _np(*_batch(8, surface15)[:5])
    out, summary = port.calibrate_sharded(mesh, spots, 0.03, bs, bm, bc,
                                          prices, config=FAST, n_starts=1,
                                          device=CPU, dtype=F64)
    rel = np.abs((out.model_prices.numpy() - prices) / prices)
    np.testing.assert_allclose(float(summary.mean_rel_error),
                               rel.mean(axis=-1).mean(), rtol=1e-12)
    np.testing.assert_allclose(float(summary.mean_loss),
                               out.loss.numpy().mean(), rtol=1e-12)
    assert int(summary.n_converged) == int(out.converged.sum())
    assert int(summary.n_total) == 8


def test_sharded_matches_jax(mesh, surface15):
    """JAX's calibrate_sharded on 8 virtual devices against the port's on
    one rank, from the same starts (JAX's, drawn from its keys), with an
    L-BFGS budget that lets both reach the loss floor (200 iterations,
    ftol 1e-13, gtol 1e-9).

    Start 0 is GUESS0, which sits on the Feller kink of the second factor
    (sigma2^2 = 2 kappa2 theta2). There JAX's autodiff of max(0, v) takes
    half the penalty's gradient and the port's K2 assembly none (as JAX's
    Pallas assembly does; ROADMAP Queue 3), so trajectories from start 0
    part from the first step, and the winners may come from different
    starts. Every surface is held to the convergence bars, and the
    trajectories from starts 1 and 2 (off the kink) to the outcome bar:
    the prices at each side's final iterate within 2e-4 relative."""
    cfg = dict(maxiter=200, ftol=1e-13, gtol=1e-9)
    spots, bs, bm, bc, prices, keys = _batch(8, surface15)
    j_out, j_sum = jax_sharded(jax_mesh(8), spots, 0.03, bs, bm, bc, prices,
                               keys, JConfig(lbfgs=JLBFGS(**cfg)), n_starts=3)
    x0 = jax.vmap(lambda s, k, m, p, ky: jax_initial_guesses(
        3, ky, s, k, m, p, jnp.float64))(spots, bs, bm, prices, keys)
    price_at = jax.vmap(lambda x, s, k, m, c: price_options(
        DHParams.from_vector(jax_transform(x)), s, 0.03, k, m, c))
    spots_np, bs_np, bm_np, bc_np, prices_np, x0 = _np(spots, bs, bm, bc,
                                                       prices, x0)
    out, summary = port.calibrate_sharded(
        mesh, spots_np, 0.03, bs_np, bm_np, bc_np, prices_np,
        config=CalibrationConfig(lbfgs=LBFGSConfig(**cfg)), n_starts=3,
        x0=x0, device=CPU, dtype=F64)
    j_loss, loss = np.asarray(j_out.loss), out.loss.numpy()
    assert np.all(j_loss < 1e-4) and np.all(loss < 1e-4)
    assert int(summary.n_total) == int(j_sum.n_total) == 8
    assert float(summary.mean_rel_error) < 1e-3
    assert float(j_sum.mean_rel_error) < 1e-3
    for start in (1, 2):
        mine = price_at(jnp.asarray(out.per_start_x.numpy()[:, start]),
                        spots, bs, bm, bc)
        theirs = price_at(j_out.per_start_x[:, start], spots, bs, bm, bc)
        np.testing.assert_allclose(np.asarray(mine), np.asarray(theirs),
                                   rtol=2e-4)
