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

  MoE block        expert-parallel (``distributed.expert_parallel``): the
                    router replicated, the expert stacks cut on E over
                    "model"; each rank routes its token rows, the routing
                    is pooled so that drops are decided over the whole
                    batch, each kept slot's row travels to its expert's rank
                    and back (``all_to_all_single``)

A tensor that does not divide tp is replicated (``sharding``'s rule), and
the layout then computes it whole.  The dense and MoE GQA / SWA decoders are
laid out here; the MLA, recurrent and frontend families and the tied head
are not yet.  The expert stacks are cut over "model" only: the reference's
FSDP "data" dimension on them is left to the optimizer state (ZeRO-1), as
every other leaf's.

Training (``loss_fn``) runs the same stream over full sequences under
autograd: the rings' backward is the other ring
(``collective_matmul._AllGatherMatmul`` / ``_ReduceScatterMatmul``), the
embedding's reduce-scatter and the head's gather transpose into each other,
and the loss is a vocab-parallel cross entropy equal to
``transformer._ce``: the row max and the sum of exponentials over the
ranks' vocabulary blocks, the gold logit from the rank owning the label.
Its parameters (``shard_train`` / ``init_shards``) keep wk / wv whole on
every rank, as the reference replicates them, and slice the rank's KV
columns at use: a rank's gradient of them is then zero outside its columns
and partial inside (its own query heads), and so is every other leaf
replicated over "model" (the norms see only the rank's token rows; a head
or table that does not divide runs on the rank's rows alone), so the sum
over "model" is the whole gradient (``data_parallel.ZeroLayout.reduce``).
Padded stream rows are zero, stay zero through every layer, and carry no
loss.  A MoE model's aux loss is the batch's: its statistics are summed over
every rank of the mesh, whose data lines hold different rows in training,
and only over the "model" line in serving, where each line serves the same
batch.
"""

from __future__ import annotations

import dataclasses
import warnings

import torch
import torch.distributed as dist

from repro_torch.core.tree import leaves, leaves_with_path, unflatten
from repro_torch.distributed import collective_matmul as cm
from repro_torch.distributed import sharding
from repro_torch.distributed.expert_parallel import ExpertParallel
from repro_torch.launch.mesh import Mesh, batch_axes
from repro_torch.models import attention as attn
from repro_torch.models import layers
from repro_torch.models.transformer import _remat
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


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


class TPLayout:
    """One rank's side of the tensor-parallel decoder: its shards of the
    parameters, and prefill / decode / the training loss over them.  Every
    rank of the mesh calls the same functions with the same replicated
    inputs (tokens, positions) and gets the same full logits (the same
    loss)."""

    def __init__(self, cfg: ArchConfig, mesh: Mesh, axis: str = "model"):
        if cfg.family not in ("dense", "moe") or cfg.attention not in ("gqa", "swa") \
                or cfg.frontend is not None or cfg.tie_embeddings:
            raise NotImplementedError(f"{cfg.name}: the tensor-parallel layout lays out the dense GQA / SWA decoder, "
                                      f"MoE or not, with an untied head (family={cfg.family!r}, "
                                      f"attention={cfg.attention!r}, frontend={cfg.frontend!r}, "
                                      f"tied head={cfg.tie_embeddings})")
        self.cfg, self.mesh, self.axis = cfg, mesh, axis
        self.tp = mesh.shape[axis]
        check_heads(cfg, self.tp)
        self.ep = None if cfg.moe is None else ExpertParallel(cfg, mesh, axis)
        if self.ep is None and cfg.d_ff % self.tp:
            raise ValueError(f"{cfg.name}: d_ff={cfg.d_ff} does not divide over tp={self.tp}")
        self.idx = mesh.axis_index(axis)
        self.kv0, self.kv1 = kv_heads(cfg, self.tp, self.idx)
        hd = cfg.resolved_head_dim
        # The rank's attention config: its own head counts (head_dim pinned).
        self.local_cfg = dataclasses.replace(cfg, n_heads=cfg.n_heads // self.tp, n_kv_heads=self.kv1 - self.kv0,
                                             head_dim=hd)
        self.vocab_sharded = cfg.vocab_size % self.tp == 0

    @property
    def group(self):
        """The "model" axis' process group (made on first use: ``new_group``
        is collective); None at tp 1."""
        return self.mesh.group(self.axis) if self.tp > 1 else None

    # -- parameters ---------------------------------------------------------

    def specs(self, params: dict) -> dict:
        """``sharding.param_specs`` over "model" alone: the expert stacks'
        FSDP "data" entry dropped (the masters stay whole over "data")."""
        baxes = set(batch_axes(self.mesh))
        return sharding._map_with_path(lambda path, spec, layers: tuple(None if ax in baxes else ax for ax in spec),
                                       sharding.param_specs(params, self.mesh))

    def shard_train(self, params: dict) -> dict:
        """This rank's training parameters: ``specs``' shard of each leaf
        (contiguous, row-major), wk / wv whole.  A replicated leaf is
        ``params``' own tensor, which a training step updates in place."""
        return sharding.shard_params(params, self.specs(params), self.mesh, _rank())

    def init_shards(self, model, seed: int, device, dtype: torch.dtype | None = torch.float32) -> dict:
        """``shard_train(model.init(seed, device, dtype=dtype))`` with each
        piece cut as soon as it is drawn (``init_model``'s ``transform``): the
        same values, one piece whole at a time (``dtype`` None: the config's
        compute dtype, as served)."""
        rank = _rank()
        return model.init(seed, device, dtype=dtype, transform=lambda piece: sharding.shard_params(
            piece, self.specs(piece), self.mesh, rank))

    def shard(self, params: dict, cut: bool = True) -> dict:
        """This rank's served parameters: ``shard_train``'s (``cut`` False:
        ``params`` are already this rank's ``shard_train`` / ``init_shards``
        tree), and of the replicated wk / wv only the columns of the rank's
        KV heads."""
        local = self.shard_train(params) if cut else sharding._map_with_path(lambda path, leaf, n: leaf, params)
        hd = self.cfg.resolved_head_dim
        for lp in local["layers"]:
            for name in ("wk", "wv"):
                lp["attn"][name] = lp["attn"][name][:, self.kv0 * hd:self.kv1 * hd].contiguous()
        return local

    def whole_shapes(self, local: dict) -> dict:
        """A tree of ``local``'s structure holding meta tensors of the whole
        leaves' shapes: each "model"-sharded dimension tp times the shard's
        (the vocabulary's only where it divides).  Raises when ``local`` is
        not a ``shard_train`` tree of this layout."""
        def whole(path, leaf, layers):
            base = sharding._param_rule(path, tuple(leaf.shape))
            vocab = path.split("/")[-1] in ("table", "w")
            shape = [d * self.tp if ax == "model" and (self.vocab_sharded or not vocab) else d
                     for d, ax in zip(leaf.shape, base)]
            return torch.empty(shape, dtype=leaf.dtype, device="meta")

        out = sharding._map_with_path(whole, local)
        specs = self.specs(out)
        for (path, w), spec, leaf in zip(leaves_with_path(out), leaves(specs), leaves(local), strict=True):
            want = tuple(d // self.tp if ax == "model" else d for d, ax in zip(w.shape, spec[-w.ndim:]))
            if want != tuple(leaf.shape):
                raise ValueError(f"{path}: shard {tuple(leaf.shape)} is not this layout's cut of a whole leaf "
                                 f"{tuple(w.shape)} over tp={self.tp}")
        return out

    def leaf_specs(self, whole: dict) -> list[tuple]:
        """Each leaf's ``param_specs`` entry in leaf order, without the layer
        axis of a leaf held in a list of layers."""
        specs = self.specs(whole)
        return leaves(sharding._map_with_path(
            lambda path, leaf, layers: sharding._get(specs, path)[0 if layers is None else 1:], whole))

    def cutters(self, whole: dict) -> dict:
        """A tree of ``whole``'s structure (``whole_shapes``) whose leaves cut
        this rank's shard out of a whole leaf: ``restore_checkpoint``'s
        ``shardings`` for the parameters."""
        rank = _rank()
        return unflatten(whole, [lambda t, spec=spec: sharding.shard_of(t, spec, self.mesh, rank)
                                 for spec in self.leaf_specs(whole)])

    def gather(self, local: dict, whole: dict, device: str | torch.device = "cpu") -> dict | None:
        """This rank's shards (``local``, of ``whole``'s structure) -> the
        whole leaves on ``device`` on the "model" line's rank 0, None on the
        others.  Every rank of the line calls it: each sends its sharded
        leaves to rank 0 as one flat fp32 buffer, which rank 0 receives one
        rank at a time; a replicated leaf is rank 0's own."""
        specs = self.leaf_specs(whole)
        loc, shapes = leaves(local), leaves(whole)
        sharded = [i for i, spec in enumerate(specs) if self.tp > 1 and any(a is not None for a in spec)]
        mine = torch.cat([loc[i].float().reshape(-1) for i in sharded]) if sharded else None
        ranks = self.mesh.axis_ranks(self.axis, _rank())
        if mine is not None and mine.is_cuda and dist.get_backend(self.group) == dist.Backend.GLOO:
            mine = mine.cpu()  # Gloo moves host tensors only
        if self.idx != 0:
            if mine is not None:
                dist.send(mine, ranks[0], group=self.group)
            return None
        out = [torch.empty(w.shape, dtype=t.dtype, device=device) for w, t in zip(shapes, loc)]
        for i, t in enumerate(loc):
            if i not in sharded:
                out[i].copy_(t)
        buf = None if mine is None else torch.empty_like(mine)
        for j in range(self.tp if sharded else 0):
            if j:
                dist.recv(buf, ranks[j], group=self.group)
            got, off = (mine if j == 0 else buf).to(device), 0
            for i in sharded:
                blk = sharding.block_of(out[i], specs[i], self.mesh, ranks[j])
                blk.copy_(got[off:off + blk.numel()].view(blk.shape))
                off += blk.numel()
        return unflatten(local, out)

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
        wk, wv = p["wk"], p["wv"]
        if wk.shape[1] == self.cfg.n_kv_heads * hd:  # the whole masters (training): the rank's KV heads' columns
            wk, wv = wk[:, self.kv0 * hd:self.kv1 * hd], wv[:, self.kv0 * hd:self.kv1 * hd]
        q = self._ag(xin, p["wq"])[:b * s].reshape(b, s, c.n_heads, hd)
        k = self._ag(xin, wk)[:b * s].reshape(b, s, c.n_kv_heads, hd)
        v = self._ag(xin, wv)[:b * s].reshape(b, s, c.n_kv_heads, hd)
        if c.qk_norm:
            q = layers.rmsnorm(p["q_norm"], q, c.norm_eps)
            k = layers.rmsnorm(p["k_norm"], k, c.norm_eps)
        return q, k, v

    def _block(self, lp: dict, x: torch.Tensor, b: int, s: int, attend, train: bool = False):
        """One pre-norm attention + SwiGLU / MoE layer on this rank's token
        rows; ``attend(q, k, v)`` -> (B, S, H_local * hd).  -> (x, the MoE
        block's aux loss, None for SwiGLU or when serving).  ``train``: the
        mesh's data lines hold different rows, whose routing the MoE block
        pools, and the aux loss is computed."""
        m_pad = x.shape[0] * self.tp
        xin = layers.rmsnorm(lp["attn_norm"], x, self.cfg.norm_eps)
        o = attend(*self._qkv(lp["attn"], xin, b, s))
        x = x + self._rs(self._pad(o.reshape(b * s, -1), m_pad), lp["attn"]["wo"])
        hin = layers.rmsnorm(lp["ffn_norm"], x, self.cfg.norm_eps)
        f = lp["ffn"]
        if self.ep is not None:
            y, aux = self.ep.block(f, hin, b * s, train=train)
            return x + y, aux
        gate, up = self._ag(hin, f["w_gate"]), self._ag(hin, f["w_up"])
        return x + self._rs(torch.nn.functional.silu(gate.float()).to(x.dtype) * up, f["w_down"]), None

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

            x = self._block(lp, x, b, s, attend)[0]
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
                            lambda q, k, v, lc=lc: attn.gqa_decode_attend(q, k, v, self.local_cfg, lc, pos))[0]
        return self._logits(params, x, torch.arange(b, device=x.device))[:, None], cache

    # -- training -----------------------------------------------------------

    def _sum(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.tp == 1 else cm.sum_over_ranks(x, self.group)

    def _ce(self, params: dict, x: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
        """This rank's (R, d) stream rows -> ``transformer._ce`` over every
        token, the same on every rank.  A vocabulary that divides is
        vocab-parallel: the final-normed rows gathered, this rank's block of
        fp32 logits, the row max and the sum of exponentials over the
        ranks, the gold logit from the rank owning the label.  Otherwise the
        whole head runs on the rank's own rows and the masked sums are
        summed over the ranks."""
        m = labels.numel()
        lab = labels.reshape(-1).long()
        wts = None if mask is None else mask.reshape(-1).float()
        count = float(m) if wts is None else wts.sum().clamp_min(1.0)
        xn = layers.rmsnorm(params["final_norm"], x, self.cfg.norm_eps)
        w = params["lm_head"]["w"].to(xn.dtype)
        if self.vocab_sharded and self.tp > 1:
            logits = layers.matmul_f32_out(cm.all_gather_rows(xn, self.group, self.tp)[:m], w)  # (m, V / tp)
            v = logits.shape[1]
            mx = cm.all_reduce_(logits.detach().amax(-1), self.group, dist.ReduceOp.MAX)
            lse = mx + torch.log(self._sum(torch.exp(logits - mx[:, None]).sum(-1)))
            local = lab - self.idx * v
            hit = (local >= 0) & (local < v)
            gold = self._sum(logits.gather(-1, local.clamp(0, v - 1)[:, None])[:, 0] * hit)
            nll = lse - gold
            return nll.mean() if wts is None else (nll * wts).sum() / count
        r = x.shape[0]
        lo, hi = min(self.idx * r, m), min((self.idx + 1) * r, m)
        logits = layers.matmul_f32_out(xn[:hi - lo], w)  # this rank's own rows, every class
        nll = torch.logsumexp(logits, -1) - logits.gather(-1, lab[lo:hi, None])[:, 0]
        own = nll.sum() if wts is None else (nll * wts[lo:hi]).sum()
        return self._sum(own) / count

    def _stream(self, params: dict, tokens: torch.Tensor, remat: bool = False):
        """The full-sequence stream over this line's rows ``tokens`` (B, S),
        the mesh's data lines holding different rows -> (this rank's (R, d)
        rows after the last layer, the MoE blocks' summed aux loss, fp32 0
        without MoE).  ``remat`` recomputes each layer in the backward, its
        collectives again, in the same order on every rank."""
        b, s = tokens.shape
        positions = torch.arange(s, dtype=torch.int32, device=tokens.device)

        def attend(q, k, v):
            return attn.gqa_attend(q, k, v, self.local_cfg, positions)[0]

        layer = _remat(lambda h, lp: self._block(lp, h, b, s, attend, train=True), remat)
        x = self._embed(params, tokens)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for lp in params["layers"]:
            x, da = layer(x, lp)
            if da is not None:
                aux = aux + da
        return x, aux

    def forward(self, params: dict, batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
        """``transformer.forward(..., return_aux=True)`` laid out over the
        ranks, on this line's rows of the batch -> (fp32 logits (B, S, V) of
        those rows, on every rank of the line; the aux loss of the whole
        batch, the same on every rank)."""
        b, s = batch["tokens"].shape
        x, aux = self._stream(params, batch["tokens"])
        return self._logits(params, x, torch.arange(b * s, device=x.device)).reshape(b, s, -1), aux

    def loss_fn(self, params: dict, batch: dict, *, remat: bool = False):
        """``transformer.loss_fn`` laid out over the ranks, on this rank's
        ``shard_train`` parameters and its line's rows of the batch ->
        (scalar loss, {"ce", "aux", "loss"}): ce over the line's rows, the
        same on every rank of the line; aux the whole batch's (0 without
        MoE), the same on every rank."""
        x, aux = self._stream(params, batch["tokens"], remat)
        ce = self._ce(params, x, batch["labels"], batch.get("loss_mask"))
        loss = ce + aux
        return loss, {"ce": ce, "aux": aux, "loss": loss}
