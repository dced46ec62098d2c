"""The port's data parallelism (`emsanet_tpu_torch/parallel/`) on the CPU.

Two ranks over gloo (`mesh.launch`, spawned processes, a file store, one
torch thread each, a timeout on the spawn and on every collective), the
R18 flagship at 64x96, dropout 0, fused training (the pairs' plain
versions), global batch 8 (`torch_parallel_cases.py`):

- the f64 two-rank step equals the port's one-process emulation (each
  half's forward and backward from the same weights, the gradients and
  the running statistics averaged, one optimizer step) to 1e-12
  relative;
- the f32 two-rank step against the JAX package's two-device
  `make_parallel_train_step` (`create_mesh(2)` on the virtual CPU mesh
  of tests/conftest.py) on the same weights (`weights.load_flax_variables`)
  and the same numpy batch, at tests/test_torch_port_train.py's
  tolerances: losses rtol 1e-4; BatchNorm running statistics atol 1e-4 /
  rtol 1e-3; parameter updates by the relative norm of the difference
  from the f64 two-rank step's, < 5e-2 over all tensors and < 0.5 per
  tensor;
- a checkpoint that rank 0 saved, loaded on both ranks, gives the same
  next step as the live state, bit for bit;
- the two-rank validation's logs (global batch 4, the last one padded)
  equal those of one process that evaluates the same images in calls of
  the same images (validation batch 2: an image's float outputs depend
  on the batch its convolutions run in), exactly;
- the trainer's `--n-devices 2` on the CPU writes one run directory;
- the batch and device checks raise with the JAX package's messages;
- the loaders' rows and `rank_rows` / `concat_rows`.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_parallel_cases as cases
from test_torch_port_model import _random_variables
from torch_port_plain import plain_host_library
from torch_tmp_files import remove_large_files

from emsanet_tpu import DataConfig as JaxDataConfig
from emsanet_tpu import EMSANetConfig as JaxEMSANetConfig
from emsanet_tpu import ModelConfig as JaxModelConfig
from emsanet_tpu.config import TrainConfig as JaxTrainConfig
from emsanet_tpu.datasets.registry import get_dataset_config as jax_ds_config
from emsanet_tpu.models import EMSANet as JaxEMSANet
from emsanet_tpu.models import init_model
from emsanet_tpu.parallel import (
    create_mesh,
    make_parallel_train_step,
    replicate_state,
    shard_batch,
)
from emsanet_tpu.training.optim import get_optimizer as jax_optimizer
from emsanet_tpu.training.step import create_train_state
from emsanet_tpu.training.step import extract_device_batch as jax_extract
from emsanet_tpu_torch import train as trainer
from emsanet_tpu_torch.data import DataLoader
from emsanet_tpu_torch.datasets.metadata import get_dataset_config
from emsanet_tpu_torch.datasets.registry import get_dataset
from emsanet_tpu_torch.models.emsanet import EMSANet
from emsanet_tpu_torch.parallel import mesh as mesh_ops
from emsanet_tpu_torch.parallel.dryrun import (
    compare_logs,
    one_process_config,
)
from emsanet_tpu_torch.preprocessing.transforms import get_preprocessor
from emsanet_tpu_torch.weights import flax_to_state_dict, load_flax_variables

SPAWN_TIMEOUT = 300  # seconds, for every spawn of ranks


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _train_loader(shard=(0, 1), n_samples=cases.B):
    cfg = cases.port_cfg(synthetic_n_samples=n_samples)
    ds = get_dataset(cfg.data, cfg.model, "train")
    ds.preprocessor = get_preprocessor(
        cfg, get_dataset_config("synthetic"), "train",
        multiscale_downscales=cfg.model.side_output_downscales)
    return DataLoader(ds, cases.B, shuffle=True, drop_last=True,
                      n_workers=1, seed=0, shard=shard), ds


def _jax_cfg():
    return JaxEMSANetConfig(
        model=JaxModelConfig(fused_training=False, **cases.model_kwargs()),
        data=JaxDataConfig(dataset="synthetic", batch_size=cases.B),
        train=JaxTrainConfig()).validate()


def _jax_parallel_step(variables, batch, cw):
    """The JAX package's 2-device step: (losses, parameters and
    batch_stats after, as port-named numpy leaves)."""
    jcfg = _jax_cfg()
    model = JaxEMSANet(cfg=jcfg.model, dataset_config=jax_ds_config(
        jcfg.data))
    mesh = create_mesh(2)
    state = replicate_state(create_train_state(
        model, variables, jax_optimizer(jcfg.train)), mesh)
    step = make_parallel_train_step(model, jcfg, jnp.asarray(cw), mesh)
    new_state, metrics = step(state, shard_batch(jax_extract(batch), mesh),
                              jax.random.PRNGKey(1))
    new = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, {
        "params": new_state.params, "batch_stats": new_state.batch_stats}))
    return ({k: float(v) for k, v in metrics.items()},
            {k: v.double().numpy() for k, v in new.items()})


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """The two ranks, the emulation (a process of its own), the train
    entry's two ranks and the JAX step run at once."""
    jcfg = _jax_cfg()
    shapes = jax.eval_shape(
        lambda k: init_model(JaxEMSANet(cfg=jcfg.model,
                                        dataset_config=jax_ds_config(
                                            jcfg.data)),
                             k, batch_size=1, train=True),
        jax.random.PRNGKey(0))
    variables = _random_variables(dict(shapes), 3)
    port = EMSANet(cases.port_cfg().model, get_dataset_config("synthetic"),
                   train=True)
    load_flax_variables(port, variables)
    state = {k: v.detach().numpy().copy()
             for k, v in port.state_dict().items()}
    loader, ds = _train_loader()
    with plain_host_library():
        batch = next(iter(loader.batches(0)))
    cw = ds.semantic_compute_class_weights()
    entry_dir = tmp_path_factory.mktemp("runs")
    ckpt_dir = cases.fresh_ckpt_dir(tmp_path_factory)
    try:
        with ThreadPoolExecutor(3) as pool:
            entry = pool.submit(_train_entry_two_cpu_ranks, entry_dir)
            ranks = pool.submit(mesh_ops.launch, cases.rank_cases, 2, "cpu",
                                state, batch, cw, ckpt_dir,
                                threads=1, timeout=SPAWN_TIMEOUT)
            emulated = pool.submit(mesh_ops.launch, cases.emulate_f64, 1,
                                   "cpu", state, batch, cw, threads=1,
                                   timeout=SPAWN_TIMEOUT)
            jax_step = _jax_parallel_step(variables, batch, cw)
            one = trainer.setup(one_process_config(cases.valid_cfg(), 2),
                                "cpu")
            one_logs = trainer.run_validation(one, 0)
            out = {"ranks": ranks.result(),
                   "emulated": emulated.result()[0], "state": state,
                   "jax": jax_step, "one_valid_logs": one_logs,
                   "entry": (entry.result(), entry_dir)}
    finally:
        remove_large_files(ckpt_dir)  # the ranks have read it back
    yield out
    remove_large_files(entry_dir)


def _rel_norm(got, want):
    return (np.linalg.norm(got - want)
            / max(np.linalg.norm(want), np.finfo(np.float64).tiny))


def _norm_check(got, want):
    """(global relative norm difference, worst per-tensor ratio), as
    tests/test_torch_port_train.py."""
    gmax = max(np.linalg.norm(v) for v in want.values())
    num = den = worst = 0.0
    for k, w in want.items():
        d = np.linalg.norm(got[k] - w) ** 2
        r = np.linalg.norm(w) ** 2
        num, den = num + d, den + r
        worst = max(worst, d ** 0.5 / max(r ** 0.5, 1e-5 * gmax))
    return (num / den) ** 0.5, worst


def test_two_rank_f64_step_equals_one_process_emulation(results):
    losses, after = results["emulated"]
    for rank in results["ranks"]:
        got_losses, got_after = rank["f64"]
        assert sorted(got_losses) == sorted(losses)
        for k, v in losses.items():
            assert abs(got_losses[k] - v) <= 1e-12 * abs(v), k
        assert sorted(got_after) == sorted(after)
        for k, v in after.items():
            assert _rel_norm(got_after[k], v) <= 1e-12, k


def test_two_rank_replicas_are_identical(results):
    r0, r1 = results["ranks"]
    for name in ("f64", "f32"):
        assert r0[name][0] == r1[name][0]
        for k, v in r0[name][1].items():
            assert np.array_equal(v, r1[name][1][k]), (name, k)


def test_two_rank_step_matches_jax_losses(results):
    want = results["jax"][0]
    got = results["ranks"][0]["f32"][0]
    assert sorted(got) == sorted(want)
    for key, v in want.items():
        np.testing.assert_allclose(got[key], v, rtol=1e-4, err_msg=key)


def test_two_rank_step_matches_jax_bn_statistics(results):
    jnew = results["jax"][1]
    after = results["ranks"][0]["f32"][1]
    keys = [k for k in after if k.endswith(("running_mean", "running_var"))]
    assert keys and set(keys) <= set(jnew)
    for k in keys:
        np.testing.assert_allclose(after[k], jnew[k], atol=1e-4, rtol=1e-3,
                                   err_msg=k)


def test_two_rank_step_matches_jax_parameter_updates(results):
    before = {k: v.astype(np.float64) for k, v in results["state"].items()
              if not k.endswith(("running_mean", "running_var"))}
    want = {k: results["ranks"][0]["f64"][1][k] - p
            for k, p in before.items()}
    for name, got_after in (("jax", results["jax"][1]),
                            ("f32", results["ranks"][0]["f32"][1])):
        glob, worst = _norm_check(
            {k: got_after[k] - p for k, p in before.items()}, want)
        assert glob < 5e-2 and worst < 0.5, (name, glob, worst)


def test_checkpoint_round_trip_under_two_ranks(results):
    for rank in results["ranks"]:
        assert rank["resume"] == {"losses_equal": True, "state_equal": True}


def test_two_rank_validation_logs_equal_one_process(results):
    got = results["ranks"][0]["valid_logs"]
    want = results["one_valid_logs"]
    assert len(want) > 10
    assert compare_logs(got, want) == []
    assert results["ranks"][1]["valid_logs"] == {}


def test_sharded_loader_rows(tmp_path):
    """Each rank's loader yields its rows of the one-process batch, bit
    for bit; `concat_rows` of the ranks' batches is that batch (the
    validation's last batch padded: `_valid_mask` cut with the rows)."""
    whole = next(iter(_train_loader()[0].batches(0)))
    parts = [next(iter(_train_loader((r, 2))[0].batches(0)))
             for r in range(2)]
    for r, part in enumerate(parts):
        _assert_same(part, mesh_ops.rank_rows(whole, r, 2))
    _assert_same(mesh_ops.concat_rows(parts), whole)
    cfg = cases.valid_cfg()
    ds = get_dataset(cfg.data, cfg.model, "valid")
    loaders = [DataLoader(ds, 4, n_workers=1, shard=s)
               for s in ((0, 1), (0, 2), (1, 2))]
    last = [list(ld.batches(0))[-1]["_valid_mask"] for ld in loaders]
    assert last[0].tolist() == [True, False, False, False]
    assert last[1].tolist() == [True, False]
    assert last[2].tolist() == [False, False]


def _assert_same(got, want, path=""):
    assert sorted(got) == sorted(want), path
    for k, w in want.items():
        g = got[k]
        if isinstance(w, dict):
            _assert_same(g, w, f"{path}/{k}")
        elif isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and np.array_equal(g, w), f"{path}/{k}"
        else:
            assert len(g) == len(w), f"{path}/{k}"


def _train_entry_two_cpu_ranks(results_dir):
    argv = ["--device", "cpu", "--dataset", "synthetic", "--n-epochs", "1",
            "--batch-size", "2", "--synthetic-n-samples", "2",
            "--input-height", "64", "--input-width", "64",
            "--rgb-encoder-backbone", "resnet18",
            "--depth-encoder-backbone", "resnet18", "--tasks",
            *cases.TASKS, "--enable-panoptic", "--fused-training",
            "--fused-inference", "--n-workers", "1", "--n-devices", "2",
            "--results-basepath", str(results_dir)]
    return trainer.main(argv)


def test_train_entry_two_cpu_ranks(results):
    """`--device cpu --n-devices 2` (run beside the fixture's other
    work): one run directory with one metrics.csv and one set of
    checkpoints, the validation's logs."""
    rc, results_dir = results["entry"]
    assert rc == 0
    (run_dir,) = (results_dir / "synthetic").iterdir()
    assert sorted(p.name for p in run_dir.iterdir()) == [
        "args.json", "argsv.txt", "artifacts", "checkpoints", "examples",
        "finished", "metrics.csv"]
    assert [p.name for p in (run_dir / "checkpoints").iterdir()] == [
        "ckpt_resume.pt"]
    rows = (run_dir / "metrics.csv").read_text().strip().splitlines()
    assert len(rows) == 2 and "valid_semantic_miou" in rows[0]


@pytest.mark.parametrize("what,argv,message", [
    ("batch", ["--batch-size", "3"],
     "batch_size=3 must be a multiple of the 2-device mesh"),
    ("validation_batch", ["--validation-batch-size", "5"],
     "validation_batch_size=5 must be a multiple of the 2-device mesh"),
    ("devices", ["--n-devices", "10", "--batch-size", "10"],
     "Requested 10 devices but only 8 available."),
])
def test_data_parallel_errors(what, argv, message):
    base = ["--device", "cpu", "--dataset", "synthetic", "--n-devices", "2"]
    with pytest.raises(ValueError, match=message):
        trainer.main(base + argv)


def test_more_ranks_than_cards_raises(monkeypatch):
    """On the card the check counts the visible cards (`create_mesh`'s
    message); the dry run alone shares one card among ranks."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="Requested 2 devices but only 1 "
                       "available."):
        mesh_ops.launch(cases.rank_cases, 2, "cuda")
    assert mesh_ops.backend_for("cuda", shared_card=False) == "nccl"
    assert mesh_ops.backend_for("cuda", shared_card=True) == "gloo"
    assert mesh_ops.backend_for("cpu", shared_card=False) == "gloo"
