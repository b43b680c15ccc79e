"""The tensor-parallel layout of the served decoder, written out.

The reference hands its TP-sharded parameters to GSPMD and lets the compiler
place every activation (``repro.serving.engine.ServeEngine(mesh=...)``).
The port has no such compiler, so this module writes the layout out, one
process a rank, over the "model" axis of a mesh (tp ranks):

  residual stream   token-sharded: each rank holds rows [idx R, (idx+1) R)
                    of the flattened (B * S, d) stream, padded with zero rows
                    to a multiple of tp (R = padded rows / tp); norms and
                    residual adds run on these rows
  wq, w_gate, w_up  column-parallel: ``all_gather_matmul`` of the token rows
                    against the rank's column block -> every token, the
                    rank's heads / d_ff columns
  wk, wv            replicated by the reference's rule; each rank computes
                    (the same all-gather matmul) and caches only the KV heads
                    its query heads read, a contiguous column range of the
                    weight -- with fewer KV heads than ranks, ranks share one
  attention         the flash kernel (prefill) or the plain decode attention
                    on the rank's own heads over every token, after rope
                    (``models/attention.py``'s ``gqa_attend`` /
                    ``gqa_decode_attend`` at the rank's head counts)
  wo, w_down        row-parallel: ``reduce_scatter_matmul`` back onto the
                    token rows, the partial sums carried in fp32
  embedding         vocab-parallel: each rank looks up the tokens in its
                    range of the table (zero rows elsewhere) and a
                    reduce-scatter sums the ranks' rows onto the token rows,
                    exactly (one rank holds each token)
  untied head       vocab-parallel, ``torch.mm`` per shard as on one card;
                    the final-normed rows are gathered first and the
                    logits' vocab blocks after, so every rank samples the
                    same greedy tokens

A tensor that does not divide tp is replicated (``sharding``'s rule), and
the layout then computes it whole.  The dense GQA / SWA decoder is laid out
here; the MoE, MLA, recurrent and frontend families and the tied head are
not yet (expert parallelism comes with them).
"""

from __future__ import annotations

import dataclasses
import warnings

import torch
import torch.distributed as dist

from repro_torch.distributed import collective_matmul as cm
from repro_torch.distributed import sharding
from repro_torch.launch.mesh import Mesh
from repro_torch.models import attention as attn
from repro_torch.models import layers
from repro_torch.models.config import ArchConfig


def check_heads(cfg: ArchConfig, tp: int) -> None:
    """Warn, as the reference does, when tp exceeds the query heads; raise
    when tp does not keep every rank on whole heads (the port never splits
    a head)."""
    if cfg.n_heads and tp > cfg.n_heads:
        warnings.warn(f"model-parallel degree {tp} exceeds n_heads={cfg.n_heads}: sharding the packed QKV would "
                      f"split the rotary head_dim across devices, which is the wrong TP layout (shard heads, not "
                      f"head_dim); use tp <= {cfg.n_heads}.")
    if cfg.n_heads % tp:
        raise ValueError(f"{cfg.name}: tp={tp} would split a head ({cfg.n_heads} query heads); the tensor-parallel "
                         f"layout keeps whole heads on each rank")


def kv_heads(cfg: ArchConfig, tp: int, idx: int) -> tuple[int, int]:
    """[kv0, kv1): the KV heads rank ``idx``'s query heads read."""
    hq = cfg.n_heads // tp
    q0 = idx * hq
    kv0, kv1 = q0 // cfg.q_per_kv, (q0 + hq - 1) // cfg.q_per_kv + 1
    if hq % (kv1 - kv0) or any((q0 + j) // cfg.q_per_kv - kv0 != j // (hq // (kv1 - kv0)) for j in range(hq)):
        raise ValueError(f"{cfg.name}: tp={tp} gives rank {idx} query heads whose KV heads are not one grouped block")
    return kv0, kv1


class TPLayout:
    """One rank's side of the tensor-parallel decoder: its shards of the
    parameters, and prefill / decode over them.  Every rank of the mesh
    calls the same functions with the same replicated inputs (tokens,
    positions) and gets the same full logits."""

    def __init__(self, cfg: ArchConfig, mesh: Mesh, axis: str = "model"):
        if cfg.family != "dense" or cfg.attention not in ("gqa", "swa") or cfg.moe is not None \
                or cfg.frontend is not None or cfg.tie_embeddings:
            raise NotImplementedError(f"{cfg.name}: tensor-parallel serving lays out the dense GQA / SWA decoder "
                                      f"with an untied head (family={cfg.family!r}, attention={cfg.attention!r})")
        self.cfg, self.mesh, self.axis = cfg, mesh, axis
        self.tp = mesh.shape[axis]
        check_heads(cfg, self.tp)
        if cfg.d_ff % self.tp:
            raise ValueError(f"{cfg.name}: d_ff={cfg.d_ff} does not divide over tp={self.tp}")
        self.idx = mesh.axis_index(axis)
        self.group = mesh.group(axis) if self.tp > 1 else None
        self.kv0, self.kv1 = kv_heads(cfg, self.tp, self.idx)
        hd = cfg.resolved_head_dim
        # The rank's attention config: its own head counts (head_dim pinned).
        self.local_cfg = dataclasses.replace(cfg, n_heads=cfg.n_heads // self.tp, n_kv_heads=self.kv1 - self.kv0,
                                             head_dim=hd)
        self.vocab_sharded = cfg.vocab_size % self.tp == 0

    # -- parameters ---------------------------------------------------------

    def shard(self, params: dict) -> dict:
        """This rank's parameters: ``sharding.param_specs``' shard of each
        leaf (contiguous, row-major), and of the replicated wk / wv only the
        columns of the rank's KV heads."""
        specs = sharding.param_specs(params, self.mesh)
        rank = dist.get_rank() if dist.is_initialized() else 0
        local = sharding.shard_params(params, specs, self.mesh, rank)
        hd = self.cfg.resolved_head_dim
        for lp in local["layers"]:
            for name in ("wk", "wv"):
                lp["attn"][name] = lp["attn"][name][:, self.kv0 * hd:self.kv1 * hd].contiguous()
        return local

    # -- collectives --------------------------------------------------------

    def _ag(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return cm.all_gather_matmul(x, w.to(x.dtype), mesh=self.mesh, axis=self.axis)

    def _rs(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return cm.reduce_scatter_matmul(x, w.to(x.dtype), mesh=self.mesh, axis=self.axis)

    def _rows(self, m: int) -> tuple[int, int]:
        """(padded rows, rows a rank) of an m-row stream."""
        r = -(-m // self.tp)
        return r * self.tp, r

    def _pad(self, x: torch.Tensor, rows: int) -> torch.Tensor:
        return x if x.shape[0] == rows else torch.cat([x, x.new_zeros((rows - x.shape[0], *x.shape[1:]))])

    def _embed(self, params: dict, tokens: torch.Tensor) -> torch.Tensor:
        """Token ids (B, S) -> this rank's (R, d) rows of the embedded stream."""
        dt = getattr(torch, self.cfg.dtype)
        table = params["embed"]["table"].to(dt)
        tok = tokens.reshape(-1)
        m_pad, r = self._rows(tok.shape[0])
        if not self.vocab_sharded:
            return self._pad(table[tok], m_pad)[self.idx * r:(self.idx + 1) * r]
        local = tok.long() - self.idx * table.shape[0]
        hit = (local >= 0) & (local < table.shape[0])
        rows = table[local.clamp(0, table.shape[0] - 1)] * hit[:, None].to(dt)  # exact zeros off this rank's range
        return cm.reduce_scatter_rows(self._pad(rows, m_pad), self.group, self.tp, self.idx)

    def _logits(self, params: dict, x: torch.Tensor, take: torch.Tensor) -> torch.Tensor:
        """The token rows ``take`` of the stream (R rows a rank) -> fp32
        logits (len(take), V) on every rank."""
        x = cm.all_gather_rows(x, self.group, self.tp)[take]
        x = layers.rmsnorm(params["final_norm"], x, self.cfg.norm_eps)
        w = params["lm_head"]["w"].to(x.dtype)
        part = layers.matmul_f32_out(x, w)
        if not self.vocab_sharded or self.tp == 1:
            return part
        blocks = cm.all_gather_rows(part, self.group, self.tp)  # (tp * n, V/tp), vocab blocks in rank order
        return blocks.reshape(self.tp, *part.shape).permute(1, 0, 2).reshape(part.shape[0], -1)

    # -- one layer ----------------------------------------------------------

    def _qkv(self, p: dict, xin: torch.Tensor, b: int, s: int):
        c, hd = self.local_cfg, self.cfg.resolved_head_dim
        q = self._ag(xin, p["wq"])[:b * s].reshape(b, s, c.n_heads, hd)
        k = self._ag(xin, p["wk"])[:b * s].reshape(b, s, c.n_kv_heads, hd)
        v = self._ag(xin, p["wv"])[:b * s].reshape(b, s, c.n_kv_heads, hd)
        if c.qk_norm:
            q = layers.rmsnorm(p["q_norm"], q, c.norm_eps)
            k = layers.rmsnorm(p["k_norm"], k, c.norm_eps)
        return q, k, v

    def _block(self, lp: dict, x: torch.Tensor, b: int, s: int, attend) -> torch.Tensor:
        """One pre-norm attention + SwiGLU layer on this rank's token rows;
        ``attend(q, k, v)`` -> (B, S, H_local * hd)."""
        m_pad = x.shape[0] * self.tp
        xin = layers.rmsnorm(lp["attn_norm"], x, self.cfg.norm_eps)
        o = attend(*self._qkv(lp["attn"], xin, b, s))
        x = x + self._rs(self._pad(o.reshape(b * s, -1), m_pad), lp["attn"]["wo"])
        hin = layers.rmsnorm(lp["ffn_norm"], x, self.cfg.norm_eps)
        f = lp["ffn"]
        gate, up = self._ag(hin, f["w_gate"]), self._ag(hin, f["w_up"])
        return x + self._rs(torch.nn.functional.silu(gate.float()).to(x.dtype) * up, f["w_down"])

    # -- serving ------------------------------------------------------------

    def init_cache(self, batch: int, max_len: int, dtype: torch.dtype, device) -> dict:
        """One KV cache per layer at the rank's KV heads."""
        return {"layers": [attn.init_gqa_cache(self.local_cfg, batch, max_len, dtype, device)
                           for _ in range(self.cfg.n_layers)]}

    def prefill(self, params: dict, batch: dict, max_len: int):
        """``transformer.prefill`` laid out over the ranks -> (last-position
        logits (B, 1, V) fp32, this rank's primed cache)."""
        tokens = batch["tokens"]
        b, s = tokens.shape
        dt = getattr(torch, self.cfg.dtype)
        cache = self.init_cache(b, max_len, dt, tokens.device)
        positions = torch.arange(s, dtype=torch.int32, device=tokens.device)
        x = self._embed(params, tokens)
        for lp, lc in zip(params["layers"], cache["layers"]):
            kv = []

            def attend(q, k, v):
                o, k = attn.gqa_attend(q, k, v, self.local_cfg, positions)
                kv.append((k, v))
                return o

            x = self._block(lp, x, b, s, attend)
            attn.gqa_prime_cache(lc, *kv[0], s)
        last = torch.arange(b, device=x.device) * s + s - 1
        return self._logits(params, x, last)[:, None], cache

    def decode_step(self, params: dict, tokens: torch.Tensor, cache: dict, pos):
        """``transformer.decode_step`` laid out over the ranks: tokens (B, 1),
        ``pos`` an int or a (B,) int32 tensor -> (logits (B, 1, V) fp32,
        cache), the cache updated in place."""
        b = tokens.shape[0]
        x = self._embed(params, tokens)
        pos = attn.slot_positions(pos, b, x.device)
        for lp, lc in zip(params["layers"], cache["layers"]):
            x = self._block(lp, x, b, 1,
                            lambda q, k, v, lc=lc: attn.gqa_decode_attend(q, k, v, self.local_cfg, lc, pos))
        return self._logits(params, x, torch.arange(b, device=x.device))[:, None], cache
