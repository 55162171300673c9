"""Two gloo processes against one: the twin of tests/test_distributed.py.

Each rank is ``tools/dist_check.py`` in a subprocess (a free loopback
port, a 300 s timeout), on the CPU. The problem is its ``tiny`` one: 7
surfaces of 6 options at float64, so at 2 ranks the second holds an
edge-padding row. The one-process run is the same module with one rank.

Bars:
  * the summaries: ``n_total`` and ``n_converged`` equal, ``mean_loss``
    and ``mean_rel_error`` within rtol 1e-9 (float64 sums in another
    order across ranks);
  * the gathered winners: equal bytes (SHA-256 of every field), since
    the lanes of the batched L-BFGS are independent and every plain op
    on the CPU path is per lane (tests/test_torch_parallel.py);
  * one data-parallel Adam step of the FFN, float64, dropout off, held
    against JAX: the all-reduced gradients and the BatchNorm running
    statistics after the step, at 2 ranks and at 1, against ``jax.grad``
    of Flax's ``SurrogateFFN`` in train mode on the whole 16-row batch
    from the same weights (``convert.flax_from_ffn_state_dict``), within
    1e-10 of each tensor's largest entry (``dist_check.ffn_grad_error``:
    float64 sums in other orders; the Dense biases that feed a BatchNorm,
    whose exact gradient is 0, at 1e-10 of a thousandth of the largest
    gradient entry; measured: 3.4e-15 at most, those biases 2.6e-13). A gradient wrong by a scale fails this: DDP summing in
    place of averaging, or the statistics' all-reduce losing its
    backward; and so do per-rank statistics (each rank normalising its
    own 8 rows). ``dist_check.ffn_reference``, the plain in-process step
    that ``chip_smoke.py`` holds the card's runs to, is held to JAX too;
  * the parameters after that Adam step: 2 ranks within 1e-6 of 1. Adam's
    first step moves each parameter by about lr times its gradient's
    sign, so this holds the signs only; the gradients are held above.
    Float64 keeps the step from turning the rounding noise of the Dense
    biases that feed a BatchNorm into steps of lr.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from option_pricing_ffn_lbfgs_tpu.surrogate import ffn as jffn
from option_pricing_ffn_lbfgs_tpu_torch import convert
from option_pricing_ffn_lbfgs_tpu_torch.surrogate.ffn import init_ffn
from option_pricing_ffn_lbfgs_tpu_torch.tools import dist_check


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    two = dist_check.launch(2, "cpu", "tiny", ddp=True,
                            save=str(d / "two.npz"), env=env)
    one = dist_check.launch(1, "cpu", "tiny", ddp=True,
                            save=str(d / "one.npz"), env=env)
    return two, one, np.load(d / "two.npz"), np.load(d / "one.npz")


def test_two_process_summary_matches_one(runs):
    two, one, _, _ = runs
    assert [line["rank"] for line in two] == [0, 1]
    assert {line["backend"] for line in two + one} == {"gloo"}
    golden = one[0]["summary"]
    assert golden["mean_loss"] < 1e-4        # the solves converge
    for line in two:
        s = line["summary"]
        assert s["n_total"] == golden["n_total"] == 7
        assert s["n_converged"] == golden["n_converged"]
        np.testing.assert_allclose(s["mean_loss"], golden["mean_loss"],
                                   rtol=1e-9)
        np.testing.assert_allclose(s["mean_rel_error"],
                                   golden["mean_rel_error"], rtol=1e-9)
        assert s["mean_rel_error"] < 1e-3
        host = line["host_summary"]
        assert host["n_total"] == 7
        np.testing.assert_allclose(s["mean_rel_error"],
                                   host["mean_rel_error"], rtol=1e-12)


def test_two_process_winners_match_one(runs):
    two, one, a, b = runs
    for line in two:
        assert line["winners_sha256"] == one[0]["winners_sha256"]
    for f in ("x", "loss", "model_prices", "converged", "per_start_x"):
        np.testing.assert_array_equal(a[f], b[f])


def test_ddp_step_matches_one_process(runs):
    two, one, a, b = runs
    assert a["ffn_params"].shape == b["ffn_params"].shape
    assert np.abs(a["ffn_params"] - b["ffn_params"]).max() <= 1e-6
    assert two[0]["ffn_checksum"] == two[1]["ffn_checksum"]


def _jax_ffn_step():
    """``jax.grad`` of the mean squared error of Flax's ``SurrogateFFN``
    (train mode, dropout off, float64) on dist_check's whole FFN batch,
    from the weights the port's DDP step starts from, with the updated
    running statistics: as ``dist_check.ffn_arrays`` keys them."""
    model = init_ffn(torch.Generator().manual_seed(1)).double()
    variables = jax.tree.map(jnp.asarray,
                             convert.flax_from_ffn_state_dict(
                                 model.state_dict()))
    x, y = (jnp.asarray(t.numpy()) for t in dist_check.ffn_batch(0, 1, "cpu"))
    jmodel = jffn.SurrogateFFN(dropout=(0.0,) * 4)

    def loss(params):
        out, upd = jmodel.apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, x,
            train=True, mutable=["batch_stats"])
        return jnp.mean((out - y) ** 2), upd

    grads, upd = jax.grad(loss, has_aux=True)(variables["params"])
    sd = convert.ffn_state_dict_from_flax(
        {"params": grads, "batch_stats": upd["batch_stats"]}, torch.float64)
    names = {n for n, _ in model.named_parameters()}
    return {(f"ffn_grad.{k}" if k in names else f"ffn_stat.{k}"): v.numpy()
            for k, v in sd.items()
            if k in names or k.endswith(("running_mean", "running_var"))}


def test_ddp_gradients_match_jax(runs):
    _, _, a, b = runs
    ref = _jax_ffn_step()
    assert len(ref) == 10 + 8 + 8          # 5 Dense, 4 BatchNorm; stats
    assert min(float(np.abs(v).max()) for k, v in ref.items()
               if k.startswith("ffn_grad.norm")) > 1e-3
    for got in (a, b, dist_check.ffn_reference("cpu")):
        assert set(ref) <= set(got)
        assert dist_check.ffn_grad_error(got, ref) <= 1e-10
