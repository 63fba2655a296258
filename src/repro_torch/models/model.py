"""Model facade: init / loss / forward / prefill / decode and the cache, the
port of ``repro/models/model.py`` for every family of the zoo (the
encoder-decoder one through ``models/whisper.py``), with the layout of
its parameters and inputs on a mesh: ``abstract_params`` and
``input_specs`` (tensors on the ``meta`` device: shapes and dtypes, no
memory) and the specs and placements of ``distribution/sharding.py``
(``param_specs``, ``param_shardings``, ``batch_shardings``)."""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.device import resolve
from repro_torch.distribution import sharding as shd
from repro_torch.models import transformer as tf
from repro_torch.models import whisper as wp
from repro_torch.models.options import RunOptions
from repro_torch.models.transformer import ParamMeta
from repro_torch.optim.adamw import tree_map

PM = ParamMeta
WHISPER_ENC_FRAMES = 1500   # cross-attention source length of the cache


def _leaves(tree, prefix=()):
    """(path, meta) pairs in sorted key order (``jax.tree``'s order)."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _set(tree, path, value):
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


_UNIFORM = {"ssm_a": (1.0, 16.0), "dt_bias": (1e-3, 1e-1)}


def materialize(meta: ParamMeta, generator: torch.Generator, device):
    """One parameter from its meta, as the reference's init kinds:
    ``normal`` scaled by 1/sqrt(fan-in), ``embed`` normal x 0.02,
    ``ssm_a`` (A_log: log of U[1, 16]), ``dt_bias`` (the inverse softplus
    of U[1e-3, 1e-1]) and ``zeros`` / ``ones``. Draws come from
    ``generator`` on its own device, so a seed gives the same weights on
    every target device."""
    dt = getattr(torch, meta.dtype)
    if meta.init == "zeros":
        return torch.zeros(meta.shape, dtype=dt, device=device)
    if meta.init == "ones":
        return torch.ones(meta.shape, dtype=dt, device=device)
    if meta.init in _UNIFORM:
        lo, hi = _UNIFORM[meta.init]
        u = lo + (hi - lo) * torch.rand(meta.shape, generator=generator,
                                        dtype=torch.float32,
                                        device=generator.device)
        x = torch.log(u) if meta.init == "ssm_a" else torch.log(torch.expm1(u))
        return x.to(device=device, dtype=dt)
    x = torch.randn(meta.shape, generator=generator, dtype=torch.float32,
                    device=generator.device)
    if meta.init == "embed":
        x = x * 0.02
    elif meta.init == "normal":
        fan_in = math.prod(meta.shape[d] for d in meta.fan_in_dims) or 1
        x = x * (1.0 / math.sqrt(fan_in))
    else:
        raise NotImplementedError(f"init kind {meta.init!r} comes with the "
                                  "families that use it")
    return x.to(device=device, dtype=dt)


class Model:
    def __init__(self, cfg: ArchConfig, opts: RunOptions = RunOptions()):
        tf.check_family(cfg)
        self.cfg = cfg
        self.opts = opts

    # ----------------------------- params --------------------------------
    def meta(self) -> Dict[str, Any]:
        m = (wp.model_meta(self.cfg) if self.cfg.family == "encdec"
             else tf.model_meta(self.cfg))
        if self.opts.param_dtype != "float32":
            # serving-mode weights (e.g. bf16): matrices only, norms fp32
            def cast(tree):
                return {k: cast(v) if isinstance(v, dict) else
                        (PM(v.shape, v.init, self.opts.param_dtype,
                            v.fan_in_dims, v.axes)
                         if len(v.shape) >= 2 and v.dtype == "float32"
                         else v)
                        for k, v in tree.items()}
            m = cast(m)
        return m

    def init(self, generator: torch.Generator, device=None) -> Dict:
        """Random parameters on ``device`` (``None`` means CUDA), drawn
        from ``generator`` leaf by leaf in sorted key order."""
        dev = resolve(device)
        params: Dict = {}
        for path, meta in _leaves(self.meta()):
            _set(params, path, materialize(meta, generator, dev))
        return params

    def abstract_params(self) -> Dict:
        """The params' shapes and dtypes as tensors on ``meta``."""
        return tree_map(lambda m: torch.empty(
            m.shape, dtype=getattr(torch, m.dtype), device="meta"),
            self.meta())

    def param_specs(self, mesh) -> Dict:
        return shd.spec_tree(self.meta(), mesh, self.opts.rules())

    def param_shardings(self, mesh) -> Dict:
        return shd.sharding_tree(self.meta(), mesh, self.opts.rules())

    def batch_axes(self, mesh):
        """The mesh axes a batch's rows are split over (the ``batch``
        rule's, as the mesh has them)."""
        with shd.use_mesh(mesh, self.opts.rules()) as c:
            return c.physical("batch")

    # ----------------------------- steps ---------------------------------
    @staticmethod
    def _tokens(params, tokens):
        return torch.as_tensor(tokens, device=params["embed"].device)

    def _encdec_batch(self, params, batch):
        return {"frames": torch.as_tensor(batch["frames"],
                                          device=params["embed"].device),
                "tokens": self._tokens(params, batch["tokens"])}

    def loss(self, params, batch, layout=None):
        """The training loss of ``batch`` (the reference's ``Model.loss``):
        ``{"tokens"}``, with ``"embeds"`` for a vlm and ``"frames"`` for
        the encoder-decoder family, arrays or tensors, taken to the
        params' device. A float32 scalar that autograd differentiates.

        With a ``layout`` (``sharding.StepLayout``) ``params`` are this
        rank's blocks, gathered at use, and ``batch`` this rank's rows:
        the result is this rank's share of the global batch's loss (the
        shares of the ranks over the batch's axes sum to it)."""
        if self.cfg.family == "encdec":
            return wp.loss_fn(params, self.cfg, self.opts,
                              self._encdec_batch(params, batch),
                              layout=layout)
        b = {"tokens": self._tokens(params, batch["tokens"])}
        if batch.get("embeds") is not None:
            b["embeds"] = torch.as_tensor(batch["embeds"],
                                          device=params["embed"].device)
        return tf.lm_loss(params, self.cfg, self.opts, b, layout=layout)

    def forward_logits(self, params, batch):
        if self.cfg.family == "encdec":
            b = self._encdec_batch(params, batch)
            enc = wp.encode(params, self.cfg, self.opts, b["frames"])
            return wp.decode_train(params, self.cfg, self.opts, b["tokens"],
                                   enc)
        embeds = batch.get("embeds")
        logits, _, _ = tf.lm_forward(params, self.cfg, self.opts,
                                     self._tokens(params, batch["tokens"]),
                                     embeds)
        return logits

    def prefill(self, params, batch, cache_len: Optional[int] = None,
                layout=None, logits: bool = False):
        """(next token, cache), and with ``logits`` the last position's
        logits. With a ``layout`` (``runtime.steps.make_prefill_step``
        across ranks) ``params`` are this rank's blocks and ``batch`` its
        rows."""
        kw = dict(cache_len=cache_len, layout=layout, logits=logits)
        if self.cfg.family == "encdec":
            return wp.prefill(params, self.cfg, self.opts,
                              self._encdec_batch(params, batch), **kw)
        return tf.lm_prefill(params, self.cfg, self.opts,
                             self._tokens(params, batch["tokens"]),
                             batch.get("embeds"), **kw)

    def decode_step(self, params, cache, token, layout=None,
                    logits: bool = False):
        step = (wp.decode_step if self.cfg.family == "encdec"
                else tf.lm_decode_step)
        return step(params, self.cfg, self.opts, cache,
                    self._tokens(params, token), layout=layout,
                    logits=logits)

    # ------------------------- cache metadata ----------------------------
    def cache_len(self, seq_len: int) -> int:
        cfg = self.cfg
        if cfg.window is not None and not cfg.global_layers:
            return min(seq_len, cfg.window)  # uniform SWA: ring buffer
        return seq_len

    def cache_meta(self, batch: int, seq_len: int) -> Dict[str, Any]:
        """Shapes and dtypes of the cache ``prefill`` returns for a
        ``seq_len`` cache: k and v in ``opts.kv_cache_dtype`` (the compute
        dtype when unset), whisper's xk and xv (L, batch, 1,500, H, hd) in
        the compute dtype."""
        cfg, cdt = self.cfg, self.opts.compute_dtype
        L = cfg.n_layers
        pos = PM((), "zeros", "int32")
        Sc = self.cache_len(seq_len)
        slot = PM((Sc,), "zeros", "int32", axes=(None,))
        kv = PM((L, batch, Sc, cfg.n_kv_heads, cfg.hd), "zeros",
                self.opts.kv_cache_dtype or cdt,
                axes=(None, "batch", "cache_seq", None, None))

        def ssm_pm(di):
            s = cfg.ssm
            GN, cw = s.n_groups * s.d_state, s.conv_width - 1
            conv = (None, "batch", None, "tensor")
            return {
                "ssm": PM((L, batch, di // s.head_dim, s.head_dim,
                           s.d_state), "zeros", "float32",
                          axes=(None, "batch", "tensor", None, None)),
                "conv_x": PM((L, batch, cw, di), "zeros", cdt, axes=conv),
                "conv_b": PM((L, batch, cw, GN), "zeros", cdt, axes=conv),
                "conv_c": PM((L, batch, cw, GN), "zeros", cdt, axes=conv)}

        if cfg.family == "ssm":
            return {"layers": ssm_pm(cfg.d_inner), "pos": pos}
        if cfg.family == "encdec":
            xkv = PM((L, batch, WHISPER_ENC_FRAMES, cfg.n_heads, cfg.hd),
                     "zeros", cdt, axes=(None, "batch", None, None, None))
            return {"k": kv, "v": kv, "xk": xkv, "xv": xkv, "pos": pos,
                    "slot_pos": slot}
        layers = {"k": kv, "v": kv}
        if cfg.family == "hybrid":
            layers.update(ssm_pm(cfg.n_heads * cfg.hd))
        return {"layers": layers, "pos": pos, "slot_pos": slot}

    def init_cache(self, batch: int, seq_len: int, device=None) -> Dict:
        """Zeros of ``cache_meta``'s shapes and dtypes on ``device``
        (``None`` means CUDA)."""
        dev = resolve(device)
        cache: Dict = {}
        for path, meta in _leaves(self.cache_meta(batch, seq_len)):
            _set(cache, path, materialize(meta, None, dev))
        return cache

    # ------------------------- input specs -------------------------------
    def input_specs(self, shape: ShapeSpec) -> Dict[str, Any]:
        """Stand-ins on ``meta`` for every step input of ``shape`` and
        their logical axes: ``{"batch", "axes"}`` for a train or prefill
        shape; for decode, ``{"cache", "cache_meta", "token",
        "token_axes"}``."""
        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len
        cdt = getattr(torch, self.opts.compute_dtype)

        def t(*s, dtype=torch.int32):
            return torch.empty(s, dtype=dtype, device="meta")

        if shape.kind in ("train", "prefill"):
            if cfg.family == "encdec":
                return {"batch": {"frames": t(B, S, cfg.d_model, dtype=cdt),
                                  "tokens": t(B, min(cfg.max_target_len,
                                                     S))},
                        "axes": {"frames": ("batch", None, None),
                                 "tokens": ("batch", None)}}
            if cfg.frontend_tokens:
                F = cfg.frontend_tokens
                return {"batch": {"embeds": t(B, F, cfg.d_model, dtype=cdt),
                                  "tokens": t(B, S - F)},
                        "axes": {"embeds": ("batch", None, None),
                                 "tokens": ("batch", None)}}
            return {"batch": {"tokens": t(B, S)},
                    "axes": {"tokens": ("batch", None)}}
        cm = self.cache_meta(B, S)
        return {"cache": tree_map(lambda m: t(*m.shape, dtype=getattr(
                    torch, m.dtype)), cm),
                "cache_meta": cm, "token": t(B), "token_axes": ("batch",)}

    def batch_shardings(self, shape: ShapeSpec, mesh) -> Dict[str, Any]:
        """A ``Placement`` for every input of ``input_specs(shape)``."""
        spec = self.input_specs(shape)
        rules = self.opts.rules()
        if shape.kind in ("train", "prefill"):
            return {k: shd.Placement(mesh, shd.spec_for(
                        tuple(v.shape), spec["axes"][k], mesh, rules))
                    for k, v in spec["batch"].items()}
        return {"cache": shd.sharding_tree(spec["cache_meta"], mesh, rules),
                "token": shd.Placement(mesh, shd.spec_for(
                    (shape.global_batch,), spec["token_axes"], mesh,
                    rules))}


def build(arch_name: str, opts: RunOptions = RunOptions(),
          reduced: bool = False) -> Model:
    from repro_torch.configs.base import get
    cfg = get(arch_name)
    if reduced:
        cfg = cfg.reduced()
    return Model(cfg, opts)
