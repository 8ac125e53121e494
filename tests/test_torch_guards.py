"""Guards of the port's rules: mxtpu_torch imports neither JAX nor
anything of mxtpu (checked in a fresh interpreter and by scanning the
source), its entry points default to the card and raise without one, and
importing it builds nothing."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "mxtpu_torch"
FORBIDDEN = ("jax", "jaxlib", "mxtpu")


@pytest.fixture(scope="module")
def mt():
    import torch
    torch.set_num_threads(1)
    import mxtpu_torch
    return mxtpu_torch


@pytest.fixture
def no_cuda():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid")


def test_import_pulls_in_no_jax_and_no_mxtpu():
    """A fresh interpreter (isolated from the environment's paths and
    site hooks) imports the package and its entry points; no jax*,
    mxtpu or mxtpu.* module may be loaded."""
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import mxtpu_torch\n"
            "from mxtpu_torch import serving, predict, convert, build\n"
            "from mxtpu_torch import (random, initializer, lr_scheduler,\n"
            "                         optimizer, metric, io, callback,\n"
            "                         model, kvstore)\n"
            "from mxtpu_torch.module import (Module, FusedTrainStep,\n"
            "                                DataParallelExecutorGroup)\n"
            "from mxtpu_torch.ops import attention, epilogue, collective\n"
            "from mxtpu_torch import autograd, gluon\n"
            "from mxtpu_torch.gluon.model_zoo import vision\n"
            "from mxtpu_torch import sharding, parallel\n"
            "from mxtpu_torch.parallel import (ring_attention, moe,\n"
            "                                  pipeline, dp, mesh)\n"
            "from mxtpu_torch import (analysis, telemetry, diagnostics,\n"
            "                         faults, tune, engine, profiler,\n"
            "                         log, name, registry)\n"
            "from mxtpu_torch.analysis import (findings, declarations,\n"
            "                                  concurrency)\n"
            "from mxtpu_torch.telemetry import (metrics, exposition,\n"
            "                                   tracing)\n"
            "from mxtpu_torch.faults import injection, retry\n"
            "from mxtpu_torch.tune import config\n"
            "from mxtpu_torch.diagnostics import flight, programs\n"
            "from mxtpu_torch import compile as _compile\n"
            "from mxtpu_torch.compile import pipeline, quant\n"
            "from mxtpu_torch.analysis import (passes, dataflow, rewrite,\n"
            "                                  equiv, graphgen, sanitizer,\n"
            "                                  provenance)\n"
            "from mxtpu_torch.analysis import __main__ as _cli\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in %r)\n"
            "print(repr(bad))\n" % (str(REPO), FORBIDDEN))
    out = subprocess.run([sys.executable, "-I", "-c", code],
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) +
                         [REPO / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_source_imports_no_jax_and_no_mxtpu(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, "%s imports %s" % (path.name, bad)


def test_predictor_without_ctx_raises_without_cuda(mt, no_cuda):
    sym = mt.models.get_transformer_lm(vocab_size=8, seq_len=4,
                                       num_layers=1, num_heads=1, d_model=8)
    with pytest.raises(mt.MXNetError, match="CUDA"):
        mt.Predictor(sym.tojson(), {}, input_shapes={"data": (1, 4)})


def test_default_context_is_gpu_and_raises_without_cuda(mt, no_cuda):
    with pytest.raises(mt.MXNetError, match="CUDA"):
        mt.current_context()
    with pytest.raises(mt.MXNetError, match="CUDA"):
        mt.serving.default_contexts()
    with pytest.raises(mt.MXNetError, match="gpu"):
        mt.gpu(0).torch_device
    with pytest.raises(mt.MXNetError, match="CUDA"):
        mt.nd.zeros((2, 2))
    assert mt.num_gpus() == 0


def test_module_without_context_raises_without_cuda(mt, no_cuda):
    """Module defaults to gpu(0): with no card it raises, and trains only
    when given cpu() explicitly."""
    sym = mt.models.get_mlp(4)
    with pytest.raises(mt.MXNetError, match="CUDA"):
        mt.mod.Module(sym)
    with pytest.raises(mt.MXNetError, match="gpu"):
        mt.mod.Module(sym, context=mt.gpu(0))
    assert mt.mod.Module(sym, context=mt.cpu())._context == [mt.cpu()]


def test_gluon_entry_points_default_to_the_card(mt, no_cuda):
    """Block.initialize, nd.array, a DataLoader's batches and the
    parameters a Trainer updates live on gpu(0) unless told otherwise:
    with no card each raises, and each works given cpu()."""
    import numpy as np
    net = mt.gluon.nn.Dense(2, in_units=3)
    with pytest.raises(mt.MXNetError, match="CUDA"):
        net.initialize()
    with pytest.raises(mt.MXNetError, match="CUDA"):
        mt.nd.array(np.ones(3))
    ds = mt.gluon.data.ArrayDataset(np.ones((4, 3), np.float32))
    with pytest.raises(mt.MXNetError, match="CUDA"):
        next(iter(mt.gluon.data.DataLoader(ds, batch_size=2)))
    net.initialize(ctx=mt.cpu())
    assert net.weight.data().context == mt.cpu()
    with mt.cpu():
        assert next(iter(mt.gluon.data.DataLoader(
            ds, batch_size=2))).context == mt.cpu()


def test_explicit_cpu_context_is_honoured(mt):
    import torch
    with mt.cpu():
        assert mt.current_context() == mt.cpu()
        assert mt.nd.zeros((2,)).context == mt.cpu()
    assert mt.cpu().torch_device == torch.device("cpu")
    assert mt.gpu(1).device_type == "gpu" and mt.gpu(1).device_id == 1


def test_import_builds_nothing_and_finds_the_sources(mt):
    assert mt.build.sources() == ["bn_relu_epilogue", "ctc_loss",
                                  "flash_attn_bwd", "flash_attn_fwd",
                                  "flash_attn_wide", "multibox_nms",
                                  "roi_pooling"]
    assert mt.build.build_log == {} or all(
        isinstance(v, dict) for v in mt.build.build_log.values())
    src, lib = mt.build._target("flash_attn_fwd")
    assert src == PKG / "csrc" / "flash_attn_fwd.cu"
    assert lib.parent == REPO / "build" / "mxtpu_torch"
    assert "arch=compute_90a,code=sm_90a" in mt.build.NVCC_FLAGS
    with pytest.raises(mt.MXNetError, match="no kernel source"):
        mt.build._target("missing_kernel")


def test_editing_a_shared_header_changes_every_library_name(mt, tmp_path,
                                                            monkeypatch):
    """A library's name digests its source and every csrc/*.cuh header,
    so an edited header builds anew instead of reusing a stale library;
    an unchanged tree keeps its name."""
    for p in (PKG / "csrc").iterdir():
        if p.suffix in (".cu", ".cuh"):
            (tmp_path / p.name).write_bytes(p.read_bytes())
    monkeypatch.setattr(mt.build, "CSRC_DIR", tmp_path)
    before = {n: mt.build._target(n)[1].name for n in mt.build.sources()}
    assert before == {n: mt.build._target(n)[1].name
                      for n in mt.build.sources()}
    header = tmp_path / "mma_sm90.cuh"
    assert header.exists()
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: mt.build._target(n)[1].name for n in mt.build.sources()}
    assert all(after[n] != before[n] for n in before)
    (tmp_path / "new_helpers.cuh").write_text("// a new header\n")
    assert all(mt.build._target(n)[1].name != after[n] for n in after)
