"""Rules the port keeps, checked without a card where possible:

- no file under ``src/repro_torch/`` and no line of ``chip_smoke.py``,
  of the chip scripts (``scripts/chip_ablate.py``,
  ``scripts/chip_compare.py``, ``scripts/chip_profile.py``,
  ``scripts/chip_examples.py``, ``scripts/chip_k3_bf16.py``,
  ``scripts/chip_k4_bf16.py``, ``scripts/chip_k3_bwd_bf16.py``), of the
  port's examples (``examples/*_torch.py``) or of the distributed tests'
  rank helper (``tests/_torch_dist.py``, which spawned ranks import)
  imports JAX or anything of the reference package ``repro``;
- importing the port builds nothing (no compiler runs at import);
- every entry point defaults to CUDA and raises when there is none
  (the multi-stream run, the serving pool, the cold tier, the sharded
  store and tier, ``rebalance``, the checkpoint readers, the per-window
  loop, the optimum, the MoE family and the encoder-decoder family with
  ``init_cache``, the train launcher, ``init_train_state`` and
  ``make_batch_iter`` among them; ``Model.loss`` and the train step run
  on CPU params), and the serve CLI refuses the encoder-decoder family
  by name;
- ``chip_smoke.py`` fails, and prints no result, without a card;
- on the CPU, every kernel wrapper (K1, K2, K3, K4) takes its plain
  version and launches nothing, and the SSM model path (``models/ssd``),
  the windowed attention path (``models/attention.banded_mha``) and the
  encoder-decoder model (``models/whisper``) run on it; off the CPU and
  the card, attention raises;
- on the card, the K1 wrapper refuses a spec beyond its limits
  (``cuda``-marked: skips here).

This file imports neither JAX nor ``repro``, so it also runs on a
machine that has only the port's dependencies.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from _torch_threads import cap_torch_threads

cap_torch_threads()

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA; none is visible")
    return torch.device("cuda")


class _Elsewhere(torch.Tensor):
    """A tensor that says it lives on a device the kernels have no path
    for (``xpu``) and holds no data: the wrappers must refuse it before
    they read it. (``meta`` has a path: the dry run's shape path.)"""

    @staticmethod
    def __new__(cls, like):
        return torch.Tensor._make_wrapper_subclass(
            cls, like.shape, dtype=like.dtype, device=torch.device("xpu"))

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        raise RuntimeError(f"{func} read a tensor with no data")


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro", "flax", "optax")


def test_port_imports_no_jax_and_no_reference():
    files = sorted(PORT.rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "scripts" / "chip_ablate.py",
        ROOT / "scripts" / "chip_compare.py",
        ROOT / "scripts" / "chip_profile.py",
        ROOT / "scripts" / "chip_examples.py",
        ROOT / "scripts" / "chip_train_dist.py",
        ROOT / "scripts" / "chip_k3_bf16.py",
        ROOT / "scripts" / "chip_k4_bf16.py",
        ROOT / "scripts" / "chip_k3_bwd_bf16.py",
        ROOT / "tests" / "_torch_dist.py"] + sorted(
        (ROOT / "examples").glob("*_torch.py"))
    assert len(files) > 15
    assert len(list((ROOT / "examples").glob("*_torch.py"))) == 8
    bad = [(str(p.relative_to(ROOT)), m) for p in files
           for m in _imports(p) if _forbidden(m)]
    assert not bad, bad


def test_port_modules_import_without_building():
    """Every module imports in a fresh process with the compiler out of
    reach, and nothing is built or loaded."""
    names = sorted(
        ".".join(("repro_torch",) + p.relative_to(PORT).with_suffix("")
                 .parts).removesuffix(".__init__")
        for p in PORT.rglob("*.py"))
    code = ("import importlib, sys\n"
            f"for name in {names!r}:\n"
            "    importlib.import_module(name)\n"
            "from repro_torch.kernels import build\n"
            "assert not build._LIBS and not build.BUILD_LOG\n"
            "assert not any(m.split('.')[0] in ('jax', 'repro')"
            " for m in sys.modules)\n")
    env = {k: v for k, v in os.environ.items()
           if k not in ("CUDA_HOME", "CUDA_PATH")}
    env.update(PATH="", PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_resolve_defaults_to_cuda_and_raises(monkeypatch):
    from repro_torch.device import resolve
    _no_cuda(monkeypatch)
    for dev in (None, "cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve(dev)
    assert resolve("cpu") == torch.device("cpu")


def test_entry_points_raise_without_cuda(monkeypatch):
    from repro_torch.configs.workloads import COVID
    from repro_torch.convert import forecaster_from_arrays
    from repro_torch.core.categories import kmeans
    from repro_torch.core.forecaster import init_forecaster
    from repro_torch.configs.base import get
    from repro_torch.core.api import Skyscraper
    from repro_torch.core.offline import fit
    from repro_torch.core.vetl_serving import BackboneVETL
    from repro_torch.launch import serve
    from repro_torch.models.model import Model
    from repro_torch.warehouse import SegmentStore
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA"):
        kmeans([[0.0, 1.0], [1.0, 0.0], [1.0, 1.0]], 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_forecaster(torch.Generator().manual_seed(0), 2, 3)
    with pytest.raises(RuntimeError, match="CUDA"):
        SegmentStore(out_dim=3)
    with pytest.raises(RuntimeError, match="CUDA"):
        fit(COVID, n_cores=8, days_unlabeled=0.5)
    with pytest.raises(RuntimeError, match="CUDA"):
        forecaster_from_arrays({"l1": {"w": [[1.0]], "b": [0.0]}})
    with pytest.raises(RuntimeError, match="CUDA"):
        Model(get("qwen1.5-0.5b").reduced()).init(
            torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        BackboneVETL()
    with pytest.raises(RuntimeError, match="CUDA"):
        Skyscraper()
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--requests", "1", "--prompt-len", "4", "--gen", "2"])


def test_cpu_tensors_take_the_plain_version():
    from repro_torch.kernels import warehouse_agg as K
    cols = {"g": torch.tensor([0, 1, 1, 2], dtype=torch.int32),
            "v": torch.tensor([1.0, 2.0, 3.0, 4.0])}
    spec = K.FusedAggSpec(filters=(), keys=(("g", 3, 0),), value="v",
                          agg="sum")
    before = K.LAUNCHES
    got = K.fused_segment_agg(cols, 4, ((), (), (), ()), spec)
    assert K.LAUNCHES == before
    assert got["acc"].tolist() == [1.0, 5.0, 4.0]
    assert got["cnt"].tolist() == [1.0, 2.0, 1.0]

    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import frame_preproc as FP
    frames = torch.arange(2 * 4 * 4 * 1, dtype=torch.float32).reshape(
        2, 4, 4, 1)
    before = FP.LAUNCHES
    down = FP.downsample(frames, 2)
    assert FP.LAUNCHES == before
    assert down[0, :, :, 0].tolist() == [[2.5, 4.5], [10.5, 12.5]]
    q = torch.randn(1, 5, 2, 8, generator=torch.Generator().manual_seed(0))
    before = FA.LAUNCHES
    out = FA.flash_attention(q, q[:, :, :1].contiguous(),
                             q[:, :, :1].contiguous())
    assert FA.LAUNCHES == before
    # causal: the first query sees only the first key
    assert torch.equal(out[0, 0, 0], q[0, 0, 0])


def test_ssd_cpu_tensors_take_the_plain_version():
    from repro_torch.kernels import ssd as K
    from repro_torch.models import ssd as S
    gen = torch.Generator().manual_seed(0)
    B, L, H, P, G, N = 1, 5, 2, 4, 1, 3
    x = torch.randn(B, L, H, P, generator=gen)
    dt = torch.rand(B, L, H, generator=gen)
    A = -torch.rand(H, generator=gen) - 0.5
    Bm = torch.randn(B, L, G, N, generator=gen)
    Cm = torch.randn(B, L, G, N, generator=gen)
    before = K.LAUNCHES
    y, state = S.ssd_scan(x, dt, A, Bm, Cm, chunk=2)
    assert K.LAUNCHES == before
    assert S.ssd_scan is K.ssd_scan
    want, want_state = S.ssd_ref(x, dt, A, Bm, Cm)
    assert float((y - want).abs().max()) < 1e-5
    assert float((state - want_state).abs().max()) < 1e-5
    with pytest.raises(ValueError, match="no kernel"):
        K.ssd_scan(*map(_Elsewhere, (x, dt, A, Bm, Cm)))
    # meta is the dry run's shape path: shapes back, nothing computed
    y, state = K.ssd_scan(x.to("meta"), dt.to("meta"), A.to("meta"),
                          Bm.to("meta"), Cm.to("meta"))
    assert y.shape == x.shape and y.device.type == "meta"


def test_ssm_entry_points_raise_without_cuda(monkeypatch):
    from repro_torch.configs.base import get
    from repro_torch.core.vetl_serving import BackboneVETL
    from repro_torch.launch import serve
    from repro_torch.models.model import Model
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA"):
        Model(get("mamba2-370m").reduced()).init(
            torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        BackboneVETL(arch="mamba2-370m")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "mamba2-370m", "--requests", "1",
                    "--prompt-len", "4", "--gen", "2"])


def test_hybrid_entry_points_raise_without_cuda(monkeypatch):
    from repro_torch.configs.base import get
    from repro_torch.core.vetl_serving import BackboneVETL
    from repro_torch.launch import serve
    from repro_torch.models.model import Model
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA"):
        Model(get("hymba-1.5b").reduced()).init(
            torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        BackboneVETL(arch="hymba-1.5b")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "hymba-1.5b", "--requests", "1",
                    "--prompt-len", "4", "--gen", "2"])


def test_comparison_and_moe_entry_points_raise_without_cuda(monkeypatch):
    """The per-window loop and the optimum (their device work: the LP,
    the window runs, the forecast) and the MoE family default to CUDA
    and raise without it; the host-numpy baselines take no device."""
    from repro_torch.configs.base import get
    from repro_torch.core import ingest
    from repro_torch.launch import serve
    from repro_torch.models.model import Model
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA"):
        ingest.run_skyscraper(None, None, n_cores=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        ingest.run_optimum(None, None, n_cores=8)
    for arch in ("mixtral-8x7b", "mixtral-8x22b"):
        with pytest.raises(RuntimeError, match="CUDA"):
            Model(get(arch).reduced()).init(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "mixtral-8x7b", "--requests", "1",
                    "--prompt-len", "4", "--gen", "2"])


def test_encdec_entry_points_raise_without_cuda(monkeypatch):
    """whisper's init and ``init_cache`` default to CUDA and raise without
    it; the serve CLI refuses the family by name whatever the device
    (its prefill needs encoder frames the CLI does not draw), and so
    does ``serve`` without ``frames``."""
    from repro_torch.configs.base import get
    from repro_torch.data.tokens import SyntheticCorpus
    from repro_torch.launch import serve
    from repro_torch.models.model import Model
    _no_cuda(monkeypatch)
    model = Model(get("whisper-large-v3").reduced())
    with pytest.raises(RuntimeError, match="CUDA"):
        model.init(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        model.init_cache(1, 8)
    for device in ("cuda", "cpu"):
        with pytest.raises(ValueError, match="frames"):
            serve.main(["--arch", "whisper-large-v3", "--requests", "1",
                        "--prompt-len", "4", "--gen", "2",
                        "--device", device])
    with pytest.raises(ValueError, match="frames"):
        serve.serve(model, {}, SyntheticCorpus(256, 0), requests=1,
                    batch=1, prompt_len=4, gen=2)


def test_training_entry_points_raise_without_cuda(monkeypatch):
    """The launcher, ``init_train_state`` and ``make_batch_iter`` default
    to CUDA and raise without it; ``Model.loss`` and the train step run
    on CPU params with the port alone (its batch goes to the params'
    device, never to a card); the launcher refuses a model axis that
    does not divide its world of one rank."""
    from repro_torch.configs.base import get
    from repro_torch.data.tokens import make_batch_iter
    from repro_torch.launch import train
    from repro_torch.models.model import Model
    from repro_torch.runtime.steps import init_train_state, make_train_step
    _no_cuda(monkeypatch)
    cfg = get("qwen1.5-0.5b").reduced()
    model = Model(cfg, train.train_options(16))
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--reduced", "--steps", "1", "--batch", "2", "--seq",
                    "16"])
    with pytest.raises(RuntimeError, match="CUDA"):
        init_train_state(model, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        next(make_batch_iter(cfg, global_batch=2, seq_len=16))
    with pytest.raises(ValueError, match="does not divide by --model-axis 2"):
        train.main(["--device", "cpu", "--model-axis", "2"])
    state = init_train_state(model, torch.Generator().manual_seed(0), "cpu")
    batch = next(make_batch_iter(cfg, global_batch=2, seq_len=16,
                                 device="cpu"))
    loss = model.loss(state["params"], {"tokens": batch["tokens"].numpy()})
    assert loss.device.type == "cpu" and bool(torch.isfinite(loss))
    state, met = make_train_step(model)(state, batch)
    assert int(state["step"]) == 1 and bool(torch.isfinite(met["loss"]))


def test_encdec_runs_on_cpu_tensors_with_the_port_alone():
    """Reduced whisper through ``serve`` on CPU tensors, with the port's
    dependencies alone: K3's wrapper takes its plain version (no
    launch), the cross k and v keep the frames' length, and a decode
    step matches the forward pass over the grown prompt. On a device
    with no kernel the cross-attention raises; it never falls back."""
    from repro_torch.configs.base import get
    from repro_torch.data.tokens import SyntheticCorpus
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch.serve import serve
    from repro_torch.models import attention as A
    from repro_torch.models.model import Model
    from repro_torch.models.options import RunOptions
    model = Model(get("whisper-large-v3").reduced(),
                  RunOptions(compute_dtype="float32"))
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    gen = torch.Generator().manual_seed(1)
    frames = torch.randn(2, 20, 64, generator=gen)
    before = FA.LAUNCHES
    stats = serve(model, params, SyntheticCorpus(256, 0), requests=3,
                  batch=2, prompt_len=6, gen=3, log=lambda line: None,
                  frames=lambda b, r0: frames[:b])
    assert FA.LAUNCHES == before
    assert [o.shape for o in stats["outputs"]] == [(2, 3), (1, 3)]
    tokens = torch.randint(0, 256, (2, 6), generator=gen)
    nxt, cache = model.prefill(params, {"frames": frames,
                                        "tokens": tokens}, cache_len=7)
    assert cache["xk"].shape == (2, 2, 20, 4, 16)
    nxt2, _ = model.decode_step(params, cache, nxt)
    grown = torch.cat([tokens, nxt[:, None].long()], 1)
    logits = model.forward_logits(params, {"frames": frames,
                                           "tokens": grown})
    assert torch.equal(nxt2, logits[:, -1].argmax(-1).to(torch.int32))
    q = torch.randn(1, 1, 4, 16, generator=gen)
    kv = torch.randn(1, 20, 4, 16, generator=gen)
    with pytest.raises(ValueError, match="no kernel"):
        A.mha(_Elsewhere(q), _Elsewhere(kv), _Elsewhere(kv), causal=False)


def test_moe_runs_on_cpu_tensors_with_the_port_alone():
    """The expert FFN on CPU tensors, with the port's dependencies alone:
    every token kept at a capacity factor of E / K, gates summing to one
    (y is then the gate-weighted sum of two experts' outputs)."""
    from repro_torch.models import moe
    g = torch.Generator().manual_seed(0)
    d, E, f = 8, 4, 12
    p = {"router": torch.randn(d, E, generator=g),
         "w_gate": torch.randn(E, d, f, generator=g),
         "w_up": torch.randn(E, d, f, generator=g),
         "w_down": torch.randn(E, f, d, generator=g)}
    x = torch.randn(2, 6, d, generator=g)
    y, aux = moe.moe_ffn(p, x, n_experts=E, top_k=2, capacity_factor=2.0)
    probs = torch.softmax(x @ p["router"], -1)
    gate, idx = moe.route(probs, 2)
    gate = gate / gate.sum(-1, keepdim=True)

    def expert(e, t):
        h = torch.nn.functional.silu(t @ p["w_gate"][e]) * (t @ p["w_up"][e])
        return h @ p["w_down"][e]
    want = torch.stack([torch.stack([
        sum(gate[b, s, j] * expert(int(idx[b, s, j]), x[b, s])
            for j in range(2)) for s in range(6)]) for b in range(2)])
    torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-5)
    assert aux.dtype == torch.float32 and float(aux) > 0


def test_sharded_warehouse_entry_points_raise_without_cuda(monkeypatch,
                                                         tmp_path):
    """The sharded store, its tier, ``rebalance`` and the checkpoint
    readers default to CUDA and raise without it; the store and file
    they are handed are on the CPU."""
    import numpy as np
    from repro_torch.checkpoint import ckpt
    from repro_torch.runtime.elastic import rebalance
    from repro_torch.warehouse import (SegmentStore, ShardedStore,
                                       ShardedTieredStore, TieredStore,
                                       load_warehouse, save_warehouse)
    store = ShardedStore(out_dim=2, n_shards=2, device="cpu")
    path = save_warehouse(str(tmp_path / "w.rsk"), TieredStore(
        SegmentStore(out_dim=2, device="cpu"), device="cpu"))
    ckpt.save(str(tmp_path / "c.rsk"), {"x": np.zeros(2, np.int32)})
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA"):
        ShardedStore(out_dim=2, n_shards=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        ShardedTieredStore(store)
    with pytest.raises(RuntimeError, match="CUDA"):
        rebalance(store, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        load_warehouse(path)
    with pytest.raises(RuntimeError, match="CUDA"):
        ckpt.restore(str(tmp_path / "c.rsk"))


def test_shard_group_defaults_to_cuda_and_raises(monkeypatch):
    """``init_shard_group`` takes a card (and NCCL) unless the CPU is
    asked for by name; without a card it raises before it joins any
    group."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import BACKENDS, init_shard_group
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_shard_group(init_method="tcp://localhost:1", rank=0,
                         world_size=1)
    assert not dist.is_initialized()
    assert BACKENDS == {"cuda": "nccl", "cpu": "gloo"}


def test_training_mesh_defaults_to_cuda_and_raises(monkeypatch):
    """A training mesh (``TrainMesh``, ``make_host_mesh``,
    ``make_production_mesh``) takes a card unless the CPU is asked for by
    name: without a card each raises before it looks for a world; on the
    CPU without a world it says to join one."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import (TrainMesh, make_host_mesh,
                                         make_production_mesh)
    _no_cuda(monkeypatch)
    for make in (lambda: TrainMesh((1, 1), ("data", "model")),
                 make_host_mesh,
                 lambda: make_production_mesh(multi_pod=True)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="join one first"):
        TrainMesh((1, 1), ("data", "model"), device="cpu")


def test_windowed_attention_on_cpu_takes_the_plain_version():
    """The banded path on CPU tensors is plain PyTorch (no K3 launch); on
    a device without a kernel it raises, it never falls back."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import attention as A
    gen = torch.Generator().manual_seed(1)
    q = torch.randn(1, 20, 4, 8, generator=gen)
    k = torch.randn(1, 20, 2, 8, generator=gen)
    v = torch.randn(1, 20, 2, 8, generator=gen)
    before = FA.LAUNCHES
    got = A.attend(q, k, v, causal=True, window=6, q_chunk=4)
    assert FA.LAUNCHES == before
    want = FA.flash_attention_ref(q, k, v, causal=True, window=6)
    assert float((got - want).abs().max()) < 1e-5
    with pytest.raises(ValueError, match="no kernel"):
        A.banded_mha(_Elsewhere(q), _Elsewhere(k), _Elsewhere(v), window=6)


def test_chip_smoke_fails_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is visible: chip_smoke.py would run")
    env = dict(os.environ, PYTHONPATH="")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          cwd=tmp_path, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """A directory with chip_smoke.py and nothing else of the repo."""
    (tmp_path / "chip_smoke.py").write_text(
        (ROOT / "chip_smoke.py").read_text())
    env = dict(os.environ, PYTHONPATH="")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def _over_limit_specs(K):
    f = tuple(("x", "ge", j) for j in range(K.MAX_FILTERS + 1))
    keys = tuple(("g", 2, 0) for _ in range(K.MAX_KEYS + 1))
    yield K.FusedAggSpec(filters=f, keys=(("g", 4, 0),), value="x",
                         agg="sum")
    yield K.FusedAggSpec(filters=(), keys=keys, value="x", agg="sum")
    yield K.FusedAggSpec(filters=(), keys=(("g", 1 << 28, 0),), value="x",
                         agg="sum")
    yield K.FusedAggSpec(filters=(), keys=(("g", 4, 0),), value="w",
                         agg="max")


@pytest.mark.cuda
def test_ssd_kernel_refuses_what_it_does_not_take(cuda):
    from repro_torch.kernels import ssd as K

    def args(B=1, S=8, H=2, P=4, G=1, N=4, dtype=torch.float32):
        return (torch.randn(B, S, H, P, device=cuda, dtype=dtype),
                torch.rand(B, S, H, device=cuda, dtype=dtype),
                -torch.rand(H, device=cuda, dtype=dtype),
                torch.randn(B, S, G, N, device=cuda, dtype=dtype),
                torch.randn(B, S, G, N, device=cuda, dtype=dtype))
    before = K.LAUNCHES
    with pytest.raises(TypeError, match="float32"):
        K.ssd_scan(*args(dtype=torch.float64))
    with pytest.raises(ValueError, match="head dims"):
        K.ssd_scan(*args(P=K.MAX_HEAD_DIM + 1))
    with pytest.raises(ValueError, match="states"):
        K.ssd_scan(*args(N=K.MAX_STATE + 1))
    with pytest.raises(ValueError, match="group"):
        K.ssd_scan(*args(H=3, G=2))
    with pytest.raises(ValueError, match="chunks"):
        K.ssd_scan(*args(), chunk=K.MAX_CHUNK + 1)
    x, dt, A, Bm, Cm = args()
    with pytest.raises(ValueError, match="contiguous"):
        K.ssd_scan(x.transpose(1, 2).contiguous().transpose(1, 2), dt, A,
                   Bm, Cm)
    with pytest.raises(ValueError, match="init_state"):
        K.ssd_scan(x, dt, A, Bm, Cm,
                   init_state=torch.zeros(1, 2, 4, 5, device=cuda))
    assert K.LAUNCHES == before


@pytest.mark.cuda
def test_kernel_refuses_specs_beyond_its_limits(cuda):
    from repro_torch.kernels import warehouse_agg as K
    n = 64
    cols = {"x": torch.rand(n, device=cuda),
            "g": torch.randint(0, 4, (n,), device=cuda, dtype=torch.int32),
            "w": torch.rand(n, 3, device=cuda)}
    nf = K.MAX_FILTERS + 1
    fvals = (torch.zeros(nf).numpy(), torch.zeros(nf).int().numpy(),
             torch.ones(nf).bool().numpy(), torch.zeros(nf).int().numpy())
    before = K.LAUNCHES
    for spec in _over_limit_specs(K):
        with pytest.raises(ValueError, match="cannot take"):
            K.fused_segment_agg(cols, n, fvals, spec)
    with pytest.raises(TypeError):
        K.fused_segment_agg({**cols, "x": cols["x"].double()}, n, fvals,
                            K.FusedAggSpec((), (("g", 4, 0),), "x", "sum"))
    with pytest.raises(ValueError, match="contiguous"):
        K.fused_segment_agg({**cols, "x": torch.rand(2 * n,
                                                     device=cuda)[::2]},
                            n, fvals,
                            K.FusedAggSpec((), (("g", 4, 0),), "x", "sum"))
    assert K.LAUNCHES == before


def test_multi_stream_pool_and_tier_entry_points_raise_without_cuda(
        monkeypatch):
    from repro_torch.configs.workloads import COVID
    from repro_torch.core import ingest
    from repro_torch.core.api import SkyscraperPool
    from repro_torch.warehouse import SegmentStore, TieredStore
    store = SegmentStore(out_dim=2, device="cpu")
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA"):
        ingest.run_skyscraper_multi([], [], n_cores_each=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        ingest.run_skyscraper_multi_windowed([], [], n_cores_each=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        TieredStore(store)

    class _Sky:                      # a fitted handle on the CPU
        _fitted = True
        device = torch.device("cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        SkyscraperPool(_Sky(), n_streams=2)
    assert COVID.name


def test_batched_switch_and_prefix_sum_on_cpu_tensors():
    """The batched decision, the stacked LP and the pool's prefix sum run
    on CPU tensors with the port's dependencies alone."""
    from repro_torch.core import api, planner, switcher
    V, C, K = 3, 2, 3
    tables = switcher.SwitchTables(
        centers=torch.tensor([[0.2, 0.5, 0.9], [0.1, 0.3, 0.6]]),
        power=torch.tensor([0.3, 0.6, 0.9]),
        cost=torch.tensor([1.0, 2.0, 4.0]),
        place_rt=torch.tensor([[0.5], [1.0], [2.0]]),
        place_on=torch.tensor([[1.0], [2.0], [4.0]]),
        place_cl=torch.zeros(3, 1), place_valid=torch.ones(3, 1, dtype=bool),
        rank_pos=torch.tensor([2, 1, 0]), tau=torch.tensor(2.0),
        buffer_cap_s=torch.tensor(10.0), cloud_budget=torch.tensor(0.0))
    stacked = switcher.stack_tables([tables] * V)
    state = switcher.init_state_multi([tables] * V)
    alpha = planner.solve_lp_stacked(stacked.centers, tables.cost,
                                     torch.full((V, C), 0.5), 6.0)
    assert alpha.shape == (V, C, K)
    torch.testing.assert_close(alpha.sum(-1), torch.ones(V, C))
    state, outs = switcher.run_window_multi(
        state, torch.rand(V, 4, K, generator=torch.Generator()
                          .manual_seed(0)),
        torch.ones(V, 4), alpha, stacked)
    assert outs["k"].shape == (V, 4) and not outs["dropped"].any()
    x = torch.arange(40, dtype=torch.float32)
    assert torch.equal(api._prefix_sum(x), torch.cumsum(x, 0))
