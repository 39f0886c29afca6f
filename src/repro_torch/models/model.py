"""Model facades (port of ``repro.models.model``): one ``nn.Module`` per
architecture family, with the reference's method names

    init(generator) -> the model, every weight drawn from ``generator``
    loss(batch) -> (scalar, metrics)        [differentiable; remat per cfg]
    forward(batch) -> (logits, aux)
    prefill(batch) -> (last logits, cache)           [inference prefill]
    init_cache(batch_size, max_seq) -> cache (a dict of tensors)
    decode_step(cache, tokens, pos) -> (logits, cache)

A batch is a dict of tensors on the model's device (``tokens`` [B,S] int,
``patches`` [B,P,D] for the VLM, ``frames`` [B,Se,D] for Whisper).  Caches
keep the reference's layout (stacked over layers), and ``decode_step``
writes the new K/V or state into the cache it is given and returns it.
``build_model(cfg, device)`` selects the family and puts it on the card
unless ``device="cpu"`` is asked for.
"""
from __future__ import annotations

import functools

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.engine import resolve_device
from repro_torch.distributed.sharding import (batch_local, current_mesh,
                                              shard_activation)
from repro_torch.models import blocks as B
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.moe import plan_groups

AUX_LOSS_WEIGHT = 0.01
Z_LOSS_WEIGHT = 1e-4


def _serving(fn):
    """``fn`` under ``torch.inference_mode``, or ``torch.no_grad`` on a
    mesh (DTensor's views cannot run in inference mode)."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with (torch.no_grad() if current_mesh() is not None
              else torch.inference_mode()):
            return fn(*args, **kwargs)
    return wrapper


def _dtype(cfg):
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _lse_gold(logits, labels):
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    return lse, gold


def cross_entropy(logits, labels, ignore_index=-1):
    """logits [B,S,V] fp32; labels [B,S] int.  Returns (loss, z_loss)."""
    mask = labels != ignore_index
    labels_safe = torch.where(mask, labels, torch.zeros_like(labels))
    # on a mesh per rank, on its batch rows with the whole vocab (DTensor's
    # gather on a split vocab fails to redistribute, and its backward
    # allocates the global logits on every rank)
    lse, gold = batch_local(_lse_gold, logits, labels_safe)
    nll = (lse - gold) * mask
    denom = torch.clamp(mask.sum(), min=1)
    z = (lse ** 2 * mask).sum() / denom
    return nll.sum() / denom, z


def param_count(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


class BaseLM(L.Module):
    """Dense / MoE / VLM decoder-only LM (GQA or MLA attention)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        dt = _dtype(cfg)
        self.emb = L.Table(cfg.vocab_size, cfg.d_model, dt, device)
        self.final_norm = L.RMSNorm(cfg.d_model, device)
        nd = cfg.moe.n_dense_layers if cfg.moe is not None else 0
        if nd:
            self.dense_stack = nn.ModuleList(
                B.DecoderBlock(cfg, use_moe=False, dtype=dt, device=device)
                for _ in range(nd))
        self.stack = nn.ModuleList(
            B.DecoderBlock(cfg, use_moe=cfg.moe is not None, dtype=dt,
                           device=device)
            for _ in range(cfg.n_layers - nd))
        if not cfg.tie_embeddings:
            self.head = L.Table(cfg.vocab_size, cfg.d_model, dt, device,
                                scale=1.0 / float(cfg.d_model) ** 0.5)
        if cfg.n_image_patches:
            self.patch_proj = L.Module()
            self.patch_proj.dense("w", cfg.d_model, cfg.d_model, dt, device)

    @property
    def device(self):
        return self.emb.w.device

    def _stacks(self):
        return ([self.dense_stack] if hasattr(self, "dense_stack") else []) \
            + [self.stack]

    # ---------------- embedding helpers ------------------------------------
    def _embed(self, batch):
        h = L.embed(self.emb, batch["tokens"])
        if self.cfg.n_image_patches:
            patches = L.matmul(batch["patches"].to(h.dtype), self.patch_proj.w)
            h = torch.cat([patches, h], dim=1)
        return shard_activation(h, "hidden")

    def _unembed(self, h):
        logits = L.unembed(self.emb if self.cfg.tie_embeddings else self.head,
                           h)
        return shard_activation(logits, "logits")

    def _positions(self, total_seq):
        return torch.arange(total_seq, device=self.device)[None, :]

    # ---------------- forward / loss ----------------------------------------
    def forward(self, batch):
        h = self._embed(batch)
        positions = self._positions(h.shape[1])
        aux = torch.zeros((), device=h.device)
        for stack in self._stacks():
            h, a = B.decoder_stack(stack, h, positions, remat=self.cfg.remat)
            aux = aux + a
        h = self.final_norm(h, self.cfg.norm_eps)
        return self._unembed(h), aux

    def loss(self, batch):
        cfg = self.cfg
        logits, aux = self.forward(batch)
        if cfg.n_image_patches:   # image positions carry no next-token loss
            logits = logits[:, cfg.n_image_patches:]
        ce, z = cross_entropy(logits, batch["labels"])
        total = ce + AUX_LOSS_WEIGHT * aux + Z_LOSS_WEIGHT * z
        return total, {"ce": ce, "aux": aux, "z": z}

    # ---------------- serving ----------------------------------------------
    def _prefill_once(self, batch):
        h = self._embed(batch)
        positions = self._positions(h.shape[1])
        caches = []
        for stack in self._stacks():
            h, kv = B.decoder_stack_prefill(stack, h, positions)
            caches.append(kv)
        h = self.final_norm(h, self.cfg.norm_eps)
        logits = self._unembed(h[:, -1:])
        cache = caches[0] if len(caches) == 1 else \
            {"dense": caches[0], "moe": caches[1]}
        return logits, cache

    @_serving
    def prefill(self, batch):
        """Prefill, processing the request batch in ``prefill_chunks``
        sequential chunks where the batch divides (bounds the MoE archs'
        activation and dispatch peak); the chunks' logits and caches are
        joined back along the batch axis.  On a mesh the batch stays whole
        on the data axes (a chunk of B / n global rows would not split over
        them: prefill_32k's 4 rows a chunk against 16 data ranks), and the
        MoE plans each chunk's rows alone (`moe.plan_groups`): every other
        layer treats rows independently, so the logits, caches and the
        pairs dropped at capacity are the chunked run's, as the
        reference's ``lax.map`` gives them; its memory bound is not."""
        nc = self.cfg.prefill_chunks
        bsz = batch["tokens"].shape[0]
        if nc <= 1 or bsz % nc:
            return self._prefill_once(batch)
        if current_mesh() is not None:
            with plan_groups(nc):
                return self._prefill_once(batch)
        step = bsz // nc
        parts = [self._prefill_once({k: v[i:i + step]
                                     for k, v in batch.items()})
                 for i in range(0, bsz, step)]
        logits = torch.cat([lg for lg, _ in parts])
        return logits, _join([c for _, c in parts])

    def input_specs(self, shape) -> dict:
        """Meta tensors standing in for a batch of ``shape`` (a
        ``ShapeConfig``): tokens (and labels to train, image patches for
        the VLM); decode's tokens are [B, 1]."""
        cfg = self.cfg
        b, s = shape.global_batch, shape.seq_len
        specs = {"tokens": _meta((b, s), torch.int64)}
        if shape.kind == "train":
            specs["labels"] = _meta((b, s), torch.int64)
        if cfg.n_image_patches:
            specs["patches"] = _meta((b, cfg.n_image_patches, cfg.d_model),
                                     _dtype(cfg))
        if shape.is_decode:
            specs["tokens"] = _meta((b, 1), torch.int64)
            specs.pop("patches", None)
        return specs

    def init_cache(self, batch_size, max_seq):
        cfg, dt, dev = self.cfg, _dtype(self.cfg), self.device

        def stack_cache(n_layers):
            if cfg.mla is not None:
                m = cfg.mla
                return {
                    "ckv": torch.zeros((n_layers, batch_size, max_seq,
                                        m.kv_lora_rank), dtype=dt, device=dev),
                    "krope": torch.zeros((n_layers, batch_size, max_seq,
                                          m.qk_rope_head_dim), dtype=dt,
                                         device=dev),
                }
            shape = (n_layers, batch_size, max_seq, cfg.n_kv_heads,
                     cfg.resolved_head_dim)
            return {"k": torch.zeros(shape, dtype=dt, device=dev),
                    "v": torch.zeros(shape, dtype=dt, device=dev)}

        if hasattr(self, "dense_stack"):
            nd = cfg.moe.n_dense_layers
            return {"dense": stack_cache(nd),
                    "moe": stack_cache(cfg.n_layers - nd)}
        return stack_cache(cfg.n_layers)

    @_serving
    def decode_step(self, cache, tokens, pos):
        h = _decode_embed(self.emb, tokens)                # [B,1,D]
        if "dense" in cache:
            h, _ = B.decoder_stack_decode(self.dense_stack, h, cache["dense"],
                                          pos)
            h, _ = B.decoder_stack_decode(self.stack, h, cache["moe"], pos)
        else:
            h, _ = B.decoder_stack_decode(self.stack, h, cache, pos)
        h = self.final_norm(h, self.cfg.norm_eps)
        return self._unembed(h), cache


def _decode_embed(emb, tokens):
    """A decode step's embedded tokens [B, 1, D] in the hidden layout.  The
    reference passes the tokens replicated and XLA gives each device the
    rows of its cache's batch shard; here the rows are taken from the
    replicated lookup (a local slice): left replicated, each rank would
    attend the whole batch and gather every cache.  Tokens already sharded
    as the batch are in that layout."""
    return shard_activation(L.embed(emb, tokens), "hidden")


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def _join(caches):
    """Join per-chunk caches ([L, b', ...] leaves) along the batch axis."""
    first = caches[0]
    if isinstance(first, dict):
        return {k: _join([c[k] for c in caches]) for k in first}
    return torch.cat(caches, dim=1)


class WhisperModel(BaseLM):
    """Encoder-decoder (whisper backbone); the conv/mel frontend is a stub:
    the batch provides precomputed frame embeddings [B, Se, D]."""

    MAX_DEC_POS = 32768

    def __init__(self, cfg: ModelConfig, device=None):
        L.Module.__init__(self)
        self.cfg = cfg
        dt = _dtype(cfg)
        self.enc_stack = nn.ModuleList(B.EncoderBlock(cfg, dt, device)
                                       for _ in range(cfg.n_encoder_layers))
        self.enc_norm = L.LayerNorm(cfg.d_model, device)
        self.emb = L.Table(cfg.vocab_size, cfg.d_model, dt, device)
        self.param("dec_pos", (self.MAX_DEC_POS, cfg.d_model), torch.float32,
                   device, 0.01)
        self.dec_stack = nn.ModuleList(B.XDecBlock(cfg, dt, device)
                                       for _ in range(cfg.n_layers))
        self.dec_norm = L.LayerNorm(cfg.d_model, device)

    def encode(self, frames):
        cfg = self.cfg
        h = frames.to(_dtype(cfg))
        h = h + L.sinusoidal_positions(h.shape[1], cfg.d_model,
                                       h.device).to(h.dtype)
        h = shard_activation(h, "hidden")
        for blk in self.enc_stack:
            h = B.maybe_remat(blk, cfg.remat)(h, None)
        return self.enc_norm(h, cfg.norm_eps)

    def _decode_seq(self, enc, tokens):
        h = L.embed(self.emb, tokens)
        h = h + self.dec_pos[:tokens.shape[1]].to(h.dtype)
        h = shard_activation(h, "hidden")
        for blk in self.dec_stack:
            h = B.maybe_remat(blk, self.cfg.remat)(h, enc, None)
        h = self.dec_norm(h, self.cfg.norm_eps)
        return L.unembed(self.emb, h)

    def forward(self, batch):
        enc = self.encode(batch["frames"])
        return self._decode_seq(enc, batch["tokens"]), \
            torch.zeros((), device=enc.device)

    def loss(self, batch):
        logits, _ = self.forward(batch)
        ce, z = cross_entropy(logits, batch["labels"])
        return ce + Z_LOSS_WEIGHT * z, {"ce": ce, "z": z}

    def input_specs(self, shape) -> dict:
        """Meta tensors standing in for a batch of ``shape``: frames and
        tokens (and labels to train); decode's tokens are [B, 1], with no
        frames."""
        cfg = self.cfg
        b, s = shape.global_batch, shape.seq_len
        specs = {"frames": _meta((b, cfg.encoder_seq_len, cfg.d_model),
                                 _dtype(cfg)),
                 "tokens": _meta((b, s), torch.int64)}
        if shape.kind == "train":
            specs["labels"] = _meta((b, s), torch.int64)
        if shape.is_decode:
            specs["tokens"] = _meta((b, 1), torch.int64)
            specs.pop("frames")
        return specs

    def init_cache(self, batch_size, max_seq):
        cfg, dt, dev = self.cfg, _dtype(self.cfg), self.device
        hd, ls = cfg.resolved_head_dim, cfg.n_layers
        self_shape = (ls, batch_size, max_seq, cfg.n_kv_heads, hd)
        cross_shape = (ls, batch_size, cfg.encoder_seq_len, cfg.n_heads, hd)
        return {"k": torch.zeros(self_shape, dtype=dt, device=dev),
                "v": torch.zeros(self_shape, dtype=dt, device=dev),
                "xk": torch.zeros(cross_shape, dtype=dt, device=dev),
                "xv": torch.zeros(cross_shape, dtype=dt, device=dev)}

    @_serving
    def prefill(self, batch):
        """The last logits and only the frozen cross K/V (the reference's
        contract: the self-attention K/V is rebuilt during decode)."""
        enc = self.encode(batch["frames"])
        xk, xv = B.xdec_cross_kv(self.dec_stack, enc)
        logits = self._decode_seq(enc, batch["tokens"])
        return logits[:, -1:], {"xk": xk, "xv": xv}

    @_serving
    def decode_step(self, cache, tokens, pos):
        h = _decode_embed(self.emb, tokens)
        h = h + self.dec_pos[pos:pos + 1].to(h.dtype)
        for i, blk in enumerate(self.dec_stack):
            with B.batch_sharded(B._slice(cache, i)) as c:
                h = blk.decode(h, c, pos)
        h = self.dec_norm(h, self.cfg.norm_eps)
        return L.unembed(self.emb, h), cache


class XLSTMModel(BaseLM):
    """xLSTM: super-layers of (slstm_every-1) mLSTM + 1 sLSTM."""

    def __init__(self, cfg: ModelConfig, device=None):
        L.Module.__init__(self)
        self.cfg = cfg
        dt = _dtype(cfg)
        self.emb = L.Table(cfg.vocab_size, cfg.d_model, dt, device)
        self.stack = nn.ModuleList(B.XLSTMSuper(cfg, dt, device)
                                   for _ in range(self._n_supers()))
        self.final_norm = L.RMSNorm(cfg.d_model, device)
        self.head = L.Table(cfg.vocab_size, cfg.d_model, dt, device,
                            scale=1.0 / float(cfg.d_model) ** 0.5)

    def _n_supers(self):
        return self.cfg.n_layers // self.cfg.xlstm.slstm_every

    def forward(self, batch):
        h = shard_activation(L.embed(self.emb, batch["tokens"]), "hidden")
        for sup in self.stack:
            h = B.maybe_remat(sup, self.cfg.remat)(h)
        h = self.final_norm(h, self.cfg.norm_eps)
        return self._unembed(h), torch.zeros((), device=h.device)

    def init_cache(self, batch_size, max_seq):
        cfg, dev = self.cfg, self.device
        g, n_m = self._n_supers(), max(cfg.xlstm.slstm_every - 1, 1)
        m_state = {k: t.expand(g, n_m, *t.shape).clone() for k, t in
                   S.mlstm_init_state(cfg, batch_size, dev).items()}
        s_state = {k: t.expand(g, *t.shape).clone() for k, t in
                   S.slstm_init_state(cfg, batch_size, dev).items()}
        return {"mlstm": m_state, "slstm": s_state}

    @_serving
    def prefill(self, batch):
        """The last logits and a fresh empty state, as the reference's
        (the state is not carried out of the prompt)."""
        logits, _ = self.forward(batch)
        return logits[:, -1:], self.init_cache(batch["tokens"].shape[0], 0)

    @_serving
    def decode_step(self, cache, tokens, pos):
        h = _decode_embed(self.emb, tokens)
        for g, sup in enumerate(self.stack):
            with B.batch_sharded(B._slice(cache, g)) as c:
                h = sup.decode(h, c)
        h = self.final_norm(h, self.cfg.norm_eps)
        return self._unembed(h), cache


class ZambaModel(BaseLM):
    """Zamba2: Mamba2 backbone + weight-shared attention block."""

    def __init__(self, cfg: ModelConfig, device=None):
        L.Module.__init__(self)
        self.cfg = cfg
        dt = _dtype(cfg)
        self.emb = L.Table(cfg.vocab_size, cfg.d_model, dt, device)
        self.stack = nn.ModuleList(B.ZambaSuper(cfg, dt, device)
                                   for _ in range(self._n_supers()))
        self.shared = B.ZambaShared(cfg, dt, device)
        self.final_norm = L.RMSNorm(cfg.d_model, device)
        self.head = L.Table(cfg.vocab_size, cfg.d_model, dt, device,
                            scale=1.0 / float(cfg.d_model) ** 0.5)

    def _n_supers(self):
        return self.cfg.n_layers // self.cfg.shared_attn_every

    def forward(self, batch):
        emb0 = shard_activation(L.embed(self.emb, batch["tokens"]), "hidden")
        positions = self._positions(emb0.shape[1])
        h = emb0
        for sup in self.stack:
            h = B.maybe_remat(sup, self.cfg.remat)(h, self.shared, emb0,
                                                   positions)
        h = self.final_norm(h, self.cfg.norm_eps)
        return self._unembed(h), torch.zeros((), device=h.device)

    def init_cache(self, batch_size, max_seq):
        cfg, dt, dev = self.cfg, _dtype(self.cfg), self.device
        g, k = self._n_supers(), cfg.shared_attn_every
        m_state = {n: t.expand(g, k, *t.shape).clone() for n, t in
                   S.mamba2_init_state(cfg, batch_size, device=dev).items()}
        shape = (g, batch_size, max_seq, cfg.n_kv_heads,
                 cfg.resolved_head_dim)
        return {"mamba": m_state,
                "k": torch.zeros(shape, dtype=dt, device=dev),
                "v": torch.zeros(shape, dtype=dt, device=dev)}

    @_serving
    def prefill(self, batch):
        """The last logits and no cache (``None``), as the reference's."""
        logits, _ = self.forward(batch)
        return logits[:, -1:], None

    @_serving
    def decode_step(self, cache, tokens, pos):
        emb0 = _decode_embed(self.emb, tokens)
        h = emb0
        for g, sup in enumerate(self.stack):
            with B.batch_sharded(B._slice(cache, g)) as c:
                h = sup.decode(h, self.shared, emb0, c, pos)
        h = self.final_norm(h, self.cfg.norm_eps)
        return self._unembed(h), cache


def model_class(cfg: ModelConfig):
    """The model class of ``cfg``'s family."""
    if cfg.family == "audio":
        return WhisperModel
    if cfg.family == "ssm" and cfg.xlstm is not None:
        return XLSTMModel
    if cfg.family == "hybrid":
        return ZambaModel
    return BaseLM


def build_model(cfg: ModelConfig, device=None) -> BaseLM:
    """The model of ``cfg``'s family, its weights allocated (not yet drawn:
    call ``init(generator)``) on ``device``: the CUDA card unless
    ``device="cpu"`` is asked for; on a host without CUDA the default
    raises."""
    return model_class(cfg)(cfg, resolve_device(device))
