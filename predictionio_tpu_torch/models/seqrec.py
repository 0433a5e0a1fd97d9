"""Sequential recommendation: causal self-attention over item histories
(the port of ``predictionio_tpu/models/seqrec.py``).

A SASRec-style next-item predictor: item and position embeddings, a
stack of ``num_blocks`` pre-LN causal self-attention blocks
(:func:`~predictionio_tpu_torch.ops.ring_attention.ring_attention` with
a key-validity mask over the left-pad slots), a position-wise FFN and
tied-embedding item scores, trained with sampled-softmax cross-entropy.

Training runs on ``device`` (the card unless the caller asks for the
CPU), or data parallel over a mesh (section "training over a mesh"):
gradients come from ``torch.autograd`` and Adam is inline with the
JAX package's clamps (bias corrections floored at 1e-9, ``sqrt(max(vh,
0))``). The batch order is ``np.random.default_rng(seed).permutation``
as in the JAX package, so batches match it row for row. The port cannot
reproduce ``jax.random``: its initial weights and its negatives come
from ``torch.Generator``\\ s seeded by ``params.seed``. Both are seams
(``init``, ``negatives``) so a test can hand in the JAX package's draws
and run the same training. TF32 stays off (PyTorch's default): every
product is a full f32 one.

Serving scores the last position's state against the item table with
one ``torch.matmul`` and a stable descending sort, so ties come out in
``lax.top_k``'s order, the lowest index first.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.ring_attention import ring_attention
from ..utils.device import DeviceLike, resolve_device

#: ``(step, shape) -> LongTensor`` of negatives in ``[0, n_items)``;
#: ``step`` counts the training steps from 0
NegativeSampler = Callable[[int, Tuple[int, ...]], torch.Tensor]

#: histories a serving call takes at once
MAX_BATCH = 1 << 16


@dataclass(frozen=True)
class SeqRecParams:
    """Hyperparameters (engine.json-compatible camelCase aliases via the
    controller's param instantiation, like every other algorithm)."""

    dim: int = 48
    heads: int = 2
    num_blocks: int = 1
    max_len: int = 50
    num_epochs: int = 10
    batch_size: int = 128
    learning_rate: float = 1e-3
    n_negatives: int = 64
    dropout: float = 0.0  # reserved; the step is deterministic
    seed: int = 7

    def __post_init__(self):
        if self.dim % self.heads != 0:
            raise ValueError("dim must divide by heads")
        if self.num_blocks < 1:
            raise ValueError("num_blocks must be >= 1 (0 would train an "
                             "attention-free embedding model silently)")


@dataclass
class SeqRecModel:
    """Learned weights (a dict of tensors on one device) and the id
    indexation."""

    weights: Dict[str, torch.Tensor]
    n_items: int
    item_ids: Optional[object] = None
    params: SeqRecParams = field(default_factory=SeqRecParams)
    #: event names the training sequences were built from: serving-time
    #: history reads filter on the same names
    events: Optional[Tuple[str, ...]] = None
    #: app the model was trained on: serving-time history reads resolve
    #: against it
    app_name: str = ""


def sequences_from_ratings(users: np.ndarray, items: np.ndarray,
                           times: np.ndarray, n_users: int,
                           max_len: int) -> np.ndarray:
    """Per-user chronological item sequences, right-aligned into a
    ``[n_users, max_len]`` window padded with -1 (older items beyond the
    window drop: the SASRec convention)."""
    order = np.lexsort((times, users))
    u, it = users[order], items[order]
    out = np.full((n_users, max_len), -1, dtype=np.int32)
    counts = np.bincount(u, minlength=n_users)
    starts = np.zeros(n_users + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    for row in range(n_users):
        s, e = starts[row], starts[row + 1]
        seq = it[s:e][-max_len:]
        if len(seq):
            out[row, -len(seq):] = seq
    return out


def _init_weights(n_items: int, p: SeqRecParams,
                  generator: Optional[torch.Generator] = None
                  ) -> Dict[str, torch.Tensor]:
    """The JAX package's names, shapes and scales, drawn on the host
    from ``generator`` (a ``torch.Generator`` seeded by ``p.seed`` when
    None), so the draw is the same whatever device trains."""
    g = generator if generator is not None else \
        torch.Generator().manual_seed(p.seed)
    d = p.dim
    s = d ** -0.5

    def normal(*shape):
        return torch.randn(shape, generator=g, dtype=torch.float32)

    w = {
        # one extra row: the padding id embeds to a learned-but-masked row
        "item_emb": normal(n_items + 1, d) * 0.02,
        "pos_emb": normal(p.max_len, d) * 0.02,
        "lnf": torch.ones(d), "lnfb": torch.zeros(d),
    }
    for blk in range(p.num_blocks):
        w.update({
            f"qkv{blk}": normal(d, 3 * d) * s,
            f"attn_out{blk}": normal(d, d) * s,
            f"ff1{blk}": normal(d, 4 * d) * s,
            f"ff2{blk}": normal(4 * d, d) * (4 * d) ** -0.5,
            f"ln1{blk}": torch.ones(d), f"ln1b{blk}": torch.zeros(d),
            f"ln2{blk}": torch.ones(d), f"ln2b{blk}": torch.zeros(d),
        })
    return w


def _layer_norm(x, g, b):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-6) * g + b


def _compat_model(model: SeqRecModel) -> SeqRecModel:
    """Models persisted by the JAX package's first single-block revision
    used unsuffixed weight keys (``qkv``, ``ln1``, ...) and params without
    ``num_blocks``: map both forward so such a blob serves. Other models
    come back as they are."""
    w = model.weights
    if "qkv" not in w or "qkv0" in w:
        return model
    ren = {"qkv": "qkv0", "attn_out": "attn_out0", "ff1": "ff10",
           "ff2": "ff20", "ln1": "ln10", "ln1b": "ln1b0", "ln2": "ln20",
           "ln2b": "ln2b0"}
    return replace(model, weights={ren.get(k, k): v for k, v in w.items()},
                   params=replace(model.params, num_blocks=1))


def p_pad_id(w) -> int:
    return w["item_emb"].shape[0] - 1


def _encode(w: Mapping[str, torch.Tensor], seq: torch.Tensor,
            p: SeqRecParams) -> torch.Tensor:
    """[B, L] padded item ids (-1 = pad) -> [B, L, dim] causal
    contextual states."""
    B, L = seq.shape
    d, H = p.dim, p.heads
    pad = (seq < 0)[..., None]
    ids = torch.where(seq < 0, p_pad_id(w), seq)
    x = w["item_emb"][ids] + w["pos_emb"][None, -L:]
    x = x.masked_fill(pad, 0.0)
    for blk in range(p.num_blocks):
        h = _layer_norm(x, w[f"ln1{blk}"], w[f"ln1b{blk}"])
        q, k, v = torch.split(h @ w[f"qkv{blk}"], d, dim=-1)
        shp = (B, L, H, d // H)
        # key_valid masks the left-pad slots: without it, real positions
        # attend to the (learned) pad keys
        attn = ring_attention(
            q.reshape(shp), k.reshape(shp), v.reshape(shp), mesh=None,
            causal=True, scale=(d // H) ** -0.5,
            key_valid=seq >= 0).reshape(B, L, d)
        x = x + (attn @ w[f"attn_out{blk}"]).masked_fill(pad, 0.0)
        h = _layer_norm(x, w[f"ln2{blk}"], w[f"ln2b{blk}"])
        x = x + (F.relu(h @ w[f"ff1{blk}"]) @ w[f"ff2{blk}"]
                 ).masked_fill(pad, 0.0)
    return _layer_norm(x, w["lnf"], w["lnfb"])


def _loss_sum(w: Mapping[str, torch.Tensor], seq: torch.Tensor,
              negs: torch.Tensor, p: SeqRecParams) -> torch.Tensor:
    """``-sum(ll)`` over a batch's valid positions: the numerator of
    :func:`sampled_softmax_loss`."""
    ctx = _encode(w, seq[:, :-1], p)                # [B, L-1, d]
    targets = seq[:, 1:]
    valid = (targets >= 0) & (seq[:, :-1] >= 0)
    tgt = torch.where(valid, targets, 0)
    cand = torch.cat([tgt[..., None], negs.to(tgt.dtype)], dim=-1)
    emb = w["item_emb"][cand]                        # [B, L-1, K+1, d]
    logits = torch.einsum("bld,blkd->blk", ctx, emb)
    ll = torch.log_softmax(logits, dim=-1)[..., 0]
    return -(torch.where(valid, ll, 0.0).sum())


def sampled_softmax_loss(w: Mapping[str, torch.Tensor], seq: torch.Tensor,
                         negs: torch.Tensor, p: SeqRecParams
                         ) -> torch.Tensor:
    """Next-item loss of one batch: positions 0..L-2 predict 1..L-1, the
    positive in slot 0 beside ``negs`` ([B, L-1, n_negatives]), averaged
    over the valid positions (at least 1)."""
    valid = (seq[:, 1:] >= 0) & (seq[:, :-1] >= 0)
    return _loss_sum(w, seq, negs, p) / valid.sum().clamp_min(1)


def loss_and_grads(w: Dict[str, torch.Tensor], seq: torch.Tensor,
                   negs: torch.Tensor, p: SeqRecParams
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The loss and its gradient with respect to every weight."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in w.items()}
    loss = sampled_softmax_loss(leaves, seq, negs, p)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads))


def _bias_correction(beta: float, step: int) -> float:
    """``max(1 - beta ** step, 1e-9)`` in f32, as the JAX step computes
    it: floored so a step of 0 divides by 1e-9, not by 0."""
    one = np.float32(1.0)
    return float(max(one - np.float32(beta) ** np.float32(step),
                     np.float32(1e-9)))


@torch.no_grad()
def adam_update(w: Dict[str, torch.Tensor], opt_m: Dict[str, torch.Tensor],
                opt_v: Dict[str, torch.Tensor],
                grads: Dict[str, torch.Tensor], step: int,
                learning_rate: float) -> None:
    """One inline Adam update in place; ``step`` is the step count after
    this update (1 for the first)."""
    b1, b2, eps = 0.9, 0.999, 1e-8
    names = list(grads)
    ws = [w[k] for k in names]
    ms = [opt_m[k] for k in names]
    vs = [opt_v[k] for k in names]
    gs = [grads[k] for k in names]
    torch._foreach_mul_(ms, b1)
    torch._foreach_add_(ms, gs, alpha=1 - b1)
    torch._foreach_mul_(vs, b2)
    torch._foreach_addcmul_(vs, gs, gs, value=1 - b2)
    mh = torch._foreach_div(ms, _bias_correction(b1, step))
    den = torch._foreach_div(vs, _bias_correction(b2, step))
    # v is a sum of squares, but rounding can leave -0-ish values
    torch._foreach_clamp_min_(den, 0.0)
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, eps)
    torch._foreach_div_(mh, den)
    torch._foreach_add_(ws, mh, alpha=-learning_rate)


def train_step(w, opt_m, opt_v, step: int, seq: torch.Tensor,
               negs: torch.Tensor, p: SeqRecParams) -> torch.Tensor:
    """One Adam step of the sampled-softmax loss, the weights and moments
    updated in place; returns the loss (on the device: no sync)."""
    loss, grads = loss_and_grads(w, seq, negs, p)
    adam_update(w, opt_m, opt_v, grads, step + 1, p.learning_rate)
    return loss


def default_negatives(n_items: int, seed: int,
                      device: torch.device) -> NegativeSampler:
    """Uniform negatives in ``[0, n_items)`` from a generator on
    ``device`` seeded by ``seed``."""
    g = torch.Generator(device=device).manual_seed(seed)

    def sample(step: int, shape: Tuple[int, ...]) -> torch.Tensor:
        return torch.randint(0, n_items, shape, generator=g, device=device)

    return sample


def train_seqrec(sequences: np.ndarray, n_items: int,
                 params: SeqRecParams, mesh=None,
                 item_ids: Optional[object] = None,
                 events: Optional[Tuple[str, ...]] = None,
                 app_name: str = "", device: DeviceLike = None,
                 init: Optional[Mapping[str, np.ndarray]] = None,
                 negatives: Optional[NegativeSampler] = None,
                 ) -> Tuple[SeqRecModel, List[float]]:
    """Train on ``[N, max_len]`` padded sequences (-1 = pad) on
    ``device``, or data parallel over ``mesh`` (module section "training
    over a mesh"). ``init`` (host arrays by weight name) replaces the
    initial draw and ``negatives`` the sampler. Returns (model,
    per-epoch mean loss); one host sync an epoch."""
    if mesh is not None:
        dev = mesh.devices[mesh.local_positions()[0]]
        n_dev = mesh.size
    else:
        dev = resolve_device(device)
        n_dev = 1
    seqs = np.asarray(sequences, dtype=np.int32)
    # keep rows with at least one (context, target) pair
    seqs = seqs[(seqs >= 0).sum(axis=1) >= 2]
    if len(seqs) == 0:
        raise ValueError("seqrec needs at least one sequence of length 2")
    if init is None:
        w = _init_weights(n_items, params)
    else:
        w = {k: torch.from_numpy(np.array(v, dtype=np.float32))
             for k, v in init.items()}
    w = {k: v.to(dev) for k, v in w.items()}
    opt_m = {k: torch.zeros_like(v) for k, v in w.items()}
    opt_v = {k: torch.zeros_like(v) for k, v in w.items()}
    sample = negatives if negatives is not None else \
        default_negatives(n_items, params.seed, dev)
    if mesh is None:
        def step_fn(step, xb, negs):
            return train_step(w, opt_m, opt_v, step, xb, negs, params)
    else:
        mesh_step = _MeshStep(w, opt_m, opt_v, mesh)

        def step_fn(step, xb, negs):
            return mesh_step.step(step, xb, negs, params)

    B = max(params.batch_size // n_dev, 1) * n_dev
    L = seqs.shape[1]
    shape = (B, L - 1, params.n_negatives)
    seqs_dev = torch.from_numpy(seqs.astype(np.int64)).to(dev)
    rng = np.random.default_rng(params.seed)
    losses: List[float] = []
    step = 0
    for _ in range(params.num_epochs):
        order = torch.from_numpy(rng.permutation(len(seqs))).to(dev)
        epoch_losses: list = []
        for s in range(0, len(seqs) - B + 1, B):
            xb = seqs_dev[order[s:s + B]]
            epoch_losses.append(step_fn(step, xb, sample(step, shape)))
            step += 1
        if not epoch_losses:  # fewer rows than one batch: one partial run
            pad_rows = torch.from_numpy(np.resize(np.arange(len(seqs)), B))
            xb = seqs_dev[pad_rows.to(dev)]
            epoch_losses.append(step_fn(step, xb, sample(step, shape)))
            step += 1
        losses.append(float(torch.stack(epoch_losses).mean()))
    return SeqRecModel(weights=w, n_items=n_items, item_ids=item_ids,
                       params=params, events=events,
                       app_name=app_name), losses


# -- training over a mesh -----------------------------------------------------
#
# Data parallel, as the JAX package's ``train_seqrec(mesh=)``: the weights
# and Adam's moments are whole on every device, the batch (``B`` rounded
# to a multiple of the mesh's size) splits its rows over every position
# (``rows_spec``), each position takes the gradient of its rows' share of
# the loss, the gradients are summed with ``all_reduce_sum`` in position
# order, and one Adam update follows on every device. The loss is the
# whole batch's, ``-sum(ll) / max(valid, 1)``, so a position's share
# divides by the GLOBAL valid count, taken from the whole batch's ids
# before any forward pass (every process holds the whole batch, as the
# JAX package's ``device_put`` of a host array needs): a mean of
# per-position means would weigh rows wrongly wherever positions hold
# windows with different padding. The negatives are drawn once for the
# whole batch, as on one card, and each position takes its rows, so both
# seams still apply and a mesh run is the one card's up to the order of
# the gradient sum.


class _MeshStep:
    """One training step over a mesh: the weights and moments of the
    first local device are the caller's, mirrored on every other device
    of the process's positions."""

    def __init__(self, w, opt_m, opt_v, mesh):
        self.mesh = mesh
        self.local = mesh.local_positions()
        first = mesh.devices[self.local[0]]
        self.names = list(w)
        self.state: Dict[str, tuple] = {str(first): (w, opt_m, opt_v)}
        for p in self.local:
            dev = mesh.devices[p]
            if str(dev) not in self.state:
                self.state[str(dev)] = tuple(
                    {k: x.to(dev, copy=True) for k, x in d.items()}
                    for d in (w, opt_m, opt_v))

    def step(self, step: int, seq: torch.Tensor, negs: torch.Tensor,
             p: SeqRecParams) -> torch.Tensor:
        """The step on the whole batch ``seq`` ([B, L]) with its
        negatives; returns the whole batch's loss (no sync)."""
        from ..parallel.collectives import all_reduce_sum, tag_position

        n = self.mesh.size
        b = seq.shape[0] // n
        valid = (seq[:, 1:] >= 0) & (seq[:, :-1] >= 0)
        n_valid = valid.sum().clamp_min(1)
        names = self.names
        flats = []
        for pos in self.local:
            dev = self.mesh.devices[pos]
            ws = self.state[str(dev)][0]
            rows = slice(pos * b, (pos + 1) * b)
            leaves = {k: v.detach().requires_grad_(True)
                      for k, v in ws.items()}
            part = _loss_sum(leaves, tag_position(seq[rows].to(dev), pos),
                             tag_position(negs[rows].to(dev), pos),
                             p) / n_valid.to(dev)
            grads = torch.autograd.grad(part, [leaves[k] for k in names])
            flats.append(torch.cat([part.detach().reshape(1)]
                                   + [g.reshape(-1) for g in grads]))
        sums = all_reduce_sum(flats, axis=None, mesh=self.mesh)
        done = set()
        for pos, total in zip(self.local, sums):
            key = str(self.mesh.devices[pos])
            if key in done:
                continue
            done.add(key)
            ws, ms, vs = self.state[key]
            grads, off = {}, 1
            for k in names:
                grads[k] = total[off:off + ws[k].numel()].view_as(ws[k])
                off += ws[k].numel()
            adam_update(ws, ms, vs, grads, step + 1, p.learning_rate)
        return sums[0][0]


def place(model: SeqRecModel, device: DeviceLike = None) -> SeqRecModel:
    """The model with its weights on ``device`` (the card by default)."""
    dev = resolve_device(device)
    if all(v.device == dev for v in model.weights.values()):
        return model
    return replace(model, weights={k: v.to(dev)
                                   for k, v in model.weights.items()})


def ranked_top_k(scores: torch.Tensor, k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The top ``k`` of each row, descending, ties in index order (the
    lowest first, as ``lax.top_k``): a stable sort, since ``torch.topk``
    on the card promises no order among equal scores."""
    vals, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def recommend_next(model: SeqRecModel, history: Sequence[int], k: int = 10
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Top-k next items for one item-id history (most recent last)."""
    ids, scores = recommend_next_batch(model, [history], k)
    return ids[0], scores[0]


def window(histories: Sequence[Sequence[int]], max_len: int) -> np.ndarray:
    """Histories right-aligned into ``[B, max_len]``, -1 padded (older
    items beyond the window drop)."""
    seq = np.full((len(histories), max_len), -1, dtype=np.int64)
    for row, history in enumerate(histories):
        h = list(history)[-max_len:]
        if h:
            seq[row, -len(h):] = h
    return seq


@torch.no_grad()
def recommend_next_batch(model: SeqRecModel,
                         histories: Sequence[Sequence[int]], k: int = 10
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Top-k next items for many histories in one pass on the weights'
    device: (ids [B, k], scores [B, k])."""
    model = _compat_model(model)
    p = model.params
    B = len(histories)
    if B > MAX_BATCH:
        raise ValueError(f"recommend_next_batch: batch of {B} exceeds "
                         f"the {MAX_BATCH} per-dispatch bound; chunk it")
    k_req = min(k, model.n_items)
    w = model.weights
    dev = w["item_emb"].device
    seq = torch.from_numpy(window(histories, p.max_len))
    if dev.type == "cuda":
        seq = seq.pin_memory().to(dev, non_blocking=True)
    ctx = _encode(w, seq, p)[:, -1]                   # [B, d]
    scores = torch.matmul(ctx, w["item_emb"][:-1].T)  # the pad row out
    vals, ids = ranked_top_k(scores, k_req)
    return ids.cpu().numpy(), vals.cpu().numpy()
