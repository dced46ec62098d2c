"""The port's model export (`emsanet_tpu_torch/export_model.py`) and its
kernels' custom ops (`ops/_native.kernel_op`) on the CPU.

- Each of the eight `emsanet::*` ops (kernels 1-8), called as the eager
  frame calls it (the R18 flagship at 128x160, f32, 'decode-planes', the
  trunk forced 'on': every op on the frame's path): its fake
  implementation gives the shapes and dtypes of its real output
  (`torch.library.opcheck`'s fake-tensor test), and its CPU
  implementation is the plain version (no kernel launch counted).
- `python -m emsanet_tpu_torch.export_model ... --with-postprocessing
  --verify` on the same model: the loaded program equals the live model
  (integer and bool maps equal, floats within 1e-5, the JAX script's
  bar), and its graph holds the eight ops.
"""

import ast

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from emsanet_tpu_torch import export_model
from emsanet_tpu_torch import train as trainer
from emsanet_tpu_torch.bench import build_flagship
from emsanet_tpu_torch.ops import _native
from emsanet_tpu_torch.parallel.dryrun import EVAL_KERNELS, launch_counts

H, W = 128, 160  # the heads defer their final x2 stage from 60x80 up
OPS = ("fused_stems", "nbt1d_chain", "group_pixels_argmin",
       "segment_hist_and_sums", "segment_lookup", "semantic_decode",
       "instance_head", "interleave_planes", "decoder_trunk")
# decoders of one block a module keep the file small
NARROW = dict(semantic_decoder_n_blocks=1, instance_decoder_n_blocks=1)
FLAGS = ["--device", "cpu", "--dataset", "synthetic", "--tasks", "semantic",
         "instance", "orientation", "scene", "--enable-panoptic",
         "--input-height", str(H), "--input-width", str(W),
         "--rgb-encoder-backbone", "resnet18", "--depth-encoder-backbone",
         "resnet18", "--fused-inference", "--head-decode-fusion",
         "decode-planes"] + [
    arg for key, value in NARROW.items() for arg in (
        "--" + key.replace("_", "-"),
        *(str(v) for v in (value if isinstance(value, tuple) else (value,))))]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _RecordOps(TorchDispatchMode):
    """The first call of each `emsanet::*` op: (op, args, kwargs)."""

    def __init__(self):
        super().__init__()
        self.calls = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ns, _, name = func._schema.name.partition("::")
        if ns == _native.OP_NAMESPACE:
            self.calls.setdefault(name, (func, args, kwargs))
        return func(*args, **kwargs)


@pytest.fixture(scope="module")
def recorded():
    model, cfg, ds = build_flagship(H, W, "float32", "resnet18",
                                    device="cpu",
                                    head_decode_fusion="decode-planes",
                                    decoder_megakernel="on", **NARROW)
    frame = export_model.Frame(model, cfg, ds.classes_is_thing, True)
    before = launch_counts(EVAL_KERNELS)
    with torch.no_grad(), _RecordOps() as rec:
        frame(*export_model.example_inputs(1, H, W, "cpu", seed=0))
    assert launch_counts(EVAL_KERNELS) == before  # plain versions only
    return rec.calls


@pytest.mark.parametrize("name", OPS)
def test_fake_implementation_matches_the_real_output(recorded, name):
    op, args, kwargs = recorded[name]
    torch.library.opcheck(op, args, kwargs, test_utils="test_faketensor")


def test_export_cli_round_trip(tmp_path, monkeypatch, capsys):
    """The CLI with `--verify`, the trunk 'on' (the CPU's 'auto' never
    takes it); the saved program's graph holds the eight ops (the CLI
    prints them)."""
    def trunk_on(a):
        cfg = make(a)
        cfg.decoder_megakernel = "on"
        return cfg

    make = trainer.model_config_from_args
    monkeypatch.setattr(trainer, "model_config_from_args", trunk_on)
    out = tmp_path / "model.pt2"
    assert export_model.main(FLAGS + ["--out", str(out),
                                      "--with-postprocessing",
                                      "--verify"]) == 0
    printed = capsys.readouterr().out
    assert "verify: the loaded program matches the live model" in printed
    # the ops the CLI found in the program it saved
    found = ast.literal_eval(printed.split("; ops ", 1)[1].split(")\n")[0])
    assert sorted(found) == sorted(OPS)
    assert found["nbt1d_chain"] > 1 and found["decoder_trunk"] == 1


@pytest.mark.parametrize("entry", ["export", "dryrun", "train_ranks",
                                   "train_distributed"])
def test_new_entry_points_default_to_the_card(entry):
    """Without `--device cpu` each new entry point asks for the card and
    raises without one (no silent CPU run)."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    from emsanet_tpu_torch.parallel import dryrun

    small = ["--dataset", "synthetic", "--batch-size", "2"]
    call = {
        "export": lambda: export_model.main(small + ["--out", "unused.pt2"]),
        "dryrun": lambda: dryrun.main(["2"]),
        "train_ranks": lambda: trainer.main(small + ["--n-devices", "2"]),
        "train_distributed": lambda: trainer.main(small + ["--distributed"]),
    }[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
