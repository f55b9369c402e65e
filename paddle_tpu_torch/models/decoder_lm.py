# ported from paddle_tpu/models/decoder_lm.py
"""Decoder-only transformer LM in PyTorch — the serving workload.

A pre-LN GPT-style decoder with learned positions, tanh-GELU and tied
input/output embeddings, the same architecture as the JAX package's
``DecoderLM``. The parameters are a plain mapping (``tok_emb``,
``pos_emb``, ``lnf_g``, ``lnf_b`` and ``layers[i]`` with ``ln1_g, ln1_b,
wq, wk, wv, wo, ln2_g, ln2_b, w1, b1, w2, b2``) in the JAX ``[in, out]``
weight layout, so ``x @ w`` is the same product in both packages;
:class:`DecoderLM` holds them as an ``nn.Module``, and
:func:`params_from_jax` carries the JAX ``init_params`` pytree across.

The decode loop is cache-layout-blind: it writes each new position's K/V
through ``cache_ops`` (serving.kv_cache.PagedKVCache or ContiguousKVCache)
before attending over the context with ``cache_ops.decode_attention``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.place import resolve_device
from ..ops import attention_ops

__all__ = ["DecoderConfig", "DecoderLM", "init_params", "params_from_jax",
           "prefill_forward", "decode_forward", "verify_forward",
           "reference_decode"]

_LAYER_KEYS = ("ln1_g", "ln1_b", "wq", "wk", "wv", "wo", "ln2_g", "ln2_b",
               "w1", "b1", "w2", "b2")


class DecoderConfig:
    """Static decoder hyperparameters."""

    def __init__(self, vocab_size: int = 256, n_layer: int = 2,
                 d_model: int = 64, n_head: int = 4, max_seq: int = 128,
                 ffn_mult: int = 4, dtype="float32"):
        if d_model % n_head != 0:
            raise ValueError("d_model must divide by n_head")
        self.vocab_size = int(vocab_size)
        self.n_layer = int(n_layer)
        self.d_model = int(d_model)
        self.n_head = int(n_head)
        self.d_head = self.d_model // self.n_head
        self.max_seq = int(max_seq)
        self.ffn_mult = int(ffn_mult)
        self.dtype = dtype if isinstance(dtype, torch.dtype) \
            else getattr(torch, str(dtype))
        self.sm_scale = 1.0 / math.sqrt(self.d_head)

    def __repr__(self):
        return ("DecoderConfig(V=%d, L=%d, d=%d, H=%d, S=%d, %s)"
                % (self.vocab_size, self.n_layer, self.d_model, self.n_head,
                   self.max_seq, self.dtype))


def init_params(cfg: DecoderConfig, seed: int = 0, device=None) -> Dict:
    """Seeded random parameters: normal(0, 0.02) weights, unit LayerNorm
    gains, zero biases. Drawn on the CPU from a ``torch.Generator`` and then
    moved, so a seed gives the same weights on every device (not the JAX
    package's: threefry and torch draw different numbers). ``device=None``
    means the card and raises without one."""
    gen = torch.Generator().manual_seed(int(seed))
    d, f = cfg.d_model, cfg.d_model * cfg.ffn_mult
    dev = resolve_device(device)

    def nrm(*shape):
        w = 0.02 * torch.randn(*shape, generator=gen)
        return w.to(device=dev, dtype=cfg.dtype)

    def ones(n):
        return torch.ones(n, dtype=cfg.dtype, device=dev)

    def zeros(n):
        return torch.zeros(n, dtype=cfg.dtype, device=dev)

    params = {"tok_emb": nrm(cfg.vocab_size, d),
              "pos_emb": nrm(cfg.max_seq, d),
              "lnf_g": ones(d), "lnf_b": zeros(d), "layers": []}
    for _ in range(cfg.n_layer):
        params["layers"].append({
            "ln1_g": ones(d), "ln1_b": zeros(d),
            "wq": nrm(d, d), "wk": nrm(d, d), "wv": nrm(d, d),
            "wo": nrm(d, d),
            "ln2_g": ones(d), "ln2_b": zeros(d),
            "w1": nrm(d, f), "b1": zeros(f), "w2": nrm(f, d), "b2": zeros(d),
        })
    return params


def params_from_jax(np_tree, cfg: DecoderConfig, device=None) -> Dict:
    """The port's parameters from the JAX ``init_params`` pytree given as
    numpy arrays (``jax.tree_util.tree_map(np.asarray, params)``). Weights
    keep the ``[in, out]`` layout; every array is checked against the
    config's shape."""
    dev = resolve_device(device)
    d, f = cfg.d_model, cfg.d_model * cfg.ffn_mult
    want_layer = {"ln1_g": (d,), "ln1_b": (d,), "wq": (d, d), "wk": (d, d),
                  "wv": (d, d), "wo": (d, d), "ln2_g": (d,), "ln2_b": (d,),
                  "w1": (d, f), "b1": (f,), "w2": (f, d), "b2": (d,)}

    def conv(name, arr, shape):
        a = np.asarray(arr)
        if a.shape != shape:
            raise ValueError("%s has shape %s, config wants %s"
                             % (name, a.shape, shape))
        return torch.as_tensor(a.astype(np.float32)).to(device=dev,
                                                        dtype=cfg.dtype)

    if len(np_tree["layers"]) != cfg.n_layer:
        raise ValueError("tree has %d layers, config wants %d"
                         % (len(np_tree["layers"]), cfg.n_layer))
    return {
        "tok_emb": conv("tok_emb", np_tree["tok_emb"], (cfg.vocab_size, d)),
        "pos_emb": conv("pos_emb", np_tree["pos_emb"], (cfg.max_seq, d)),
        "lnf_g": conv("lnf_g", np_tree["lnf_g"], (d,)),
        "lnf_b": conv("lnf_b", np_tree["lnf_b"], (d,)),
        "layers": [{k: conv("layers[%d].%s" % (i, k), lp[k], want_layer[k])
                    for k in _LAYER_KEYS}
                   for i, lp in enumerate(np_tree["layers"])],
    }


def _ln(x, g, b, eps=1e-5):
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * g + b


def _ffn(x, lp):
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x @ lp["w1"] + lp["b1"], approximate="tanh") @ lp["w2"] \
        + lp["b2"]


@torch.no_grad()
def prefill_forward(params, cfg: DecoderConfig, tokens, lengths
                    ) -> Tuple[torch.Tensor, List[Tuple[torch.Tensor,
                                                        torch.Tensor]]]:
    """Full causal forward over (bucket-padded) prompts.

    ``tokens`` [B,S] int, ``lengths`` [B]. Returns (logits [B,S,V], kvs)
    where ``kvs`` is one (k, v) pair [B,S,H,D] per layer for the caller to
    write into its cache layout. Padding positions are masked out of valid
    queries' attention via segment ids; their own rows are garbage the
    caller must ignore (read logits at ``lengths-1``, write KV < length).
    """
    b, s = tokens.shape
    x = params["tok_emb"][tokens] + params["pos_emb"][:s][None]
    pos = torch.arange(s, device=tokens.device)
    valid = (pos[None, :] < lengths[:, None]).to(torch.int32)
    kvs = []
    for lp in params["layers"]:
        h = _ln(x, lp["ln1_g"], lp["ln1_b"])
        q = (h @ lp["wq"]).reshape(b, s, cfg.n_head, cfg.d_head)
        k = (h @ lp["wk"]).reshape(b, s, cfg.n_head, cfg.d_head)
        v = (h @ lp["wv"]).reshape(b, s, cfg.n_head, cfg.d_head)
        kvs.append((k, v))
        o = attention_ops.sdpa(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            segment_ids_q=valid, segment_ids_kv=valid,
            causal=True, sm_scale=cfg.sm_scale)
        x = x + o.transpose(1, 2).reshape(b, s, cfg.d_model) @ lp["wo"]
        x = x + _ffn(_ln(x, lp["ln2_g"], lp["ln2_b"]), lp)
    x = _ln(x, params["lnf_g"], params["lnf_b"])
    return x @ params["tok_emb"].T, kvs


@torch.no_grad()
def decode_forward(params, cfg: DecoderConfig, cache, cache_ops, tokens,
                   pos, active):
    """One incremental decode position for every batch slot.

    ``tokens``/``pos``/``active`` are [B]; the token at ``pos[b]`` has its
    K/V written into the cache (inactive slots' writes land nowhere a read
    can see) BEFORE attention over the context masked to ``pos+1`` valid
    positions, dispatched through ``cache_ops.decode_attention`` so the
    layout owns the gather-vs-kernel choice. The cache is updated in place;
    returns (logits [B,V], cache)."""
    b = tokens.shape[0]
    pos_c = pos.clamp(0, cfg.max_seq - 1)
    x = params["tok_emb"][tokens] + params["pos_emb"][pos_c]
    ctx_len = (pos + 1).to(torch.int32)
    for i, lp in enumerate(params["layers"]):
        h = _ln(x, lp["ln1_g"], lp["ln1_b"])
        q = (h @ lp["wq"]).reshape(b, cfg.n_head, cfg.d_head)
        k = (h @ lp["wk"]).reshape(b, cfg.n_head, cfg.d_head)
        v = (h @ lp["wv"]).reshape(b, cfg.n_head, cfg.d_head)
        cache = cache_ops.write_token(cache, i, k, v, pos, active)
        o = cache_ops.decode_attention(cache, i, q, ctx_len,
                                       sm_scale=cfg.sm_scale)
        x = x + o.reshape(b, cfg.d_model) @ lp["wo"]
        x = x + _ffn(_ln(x, lp["ln2_g"], lp["ln2_b"]), lp)
    x = _ln(x, params["lnf_g"], params["lnf_b"])
    return x @ params["tok_emb"].T, cache


@torch.no_grad()
def verify_forward(params, cfg: DecoderConfig, cache, cache_ops, tokens, pos,
                   active, write_mask):
    """Speculative verify window: ``decode_forward`` over W consecutive
    positions per slot in ONE forward.

    ``tokens`` [B,W] is each slot's window — position 0 its pending next
    token, positions 1..W-1 the drafter's proposals; window position ``j``
    sits at logical position ``pos[b] + j``. All W positions' K/V are
    written BEFORE attention (the same write-then-attend order as decode),
    gated per position by ``write_mask`` [B,W] — the engine masks writes
    that would run past the slot's reservation (``gen + j >= max_new`` or
    ``pos + j >= max_ctx``), because those positions' page-table entries
    are unreserved and an unguarded scatter would land on another slot's
    page. The W writes of a layer are one scatter
    (``cache_ops.write_window``; the unmasked rows are distinct, so it is
    the JAX package's loop of ``write_token`` calls). Attention dispatches
    through ``cache_ops.decode_verify`` (ragged per-row lengths ``pos + 1 +
    j`` give in-window causality): on the card, K3 over B*W pseudo-slots.
    Returns (logits [B,W,V], cache). With W=1 and write_mask=active this is
    ``decode_forward`` on the same math."""
    b, w = tokens.shape
    posw = pos[:, None] + torch.arange(w, device=tokens.device)[None, :]
    pos_c = posw.clamp(0, cfg.max_seq - 1)
    x = params["tok_emb"][tokens] + params["pos_emb"][pos_c]
    ctx_len = (pos + 1).to(torch.int32)
    for i, lp in enumerate(params["layers"]):
        h = _ln(x, lp["ln1_g"], lp["ln1_b"])
        q = (h @ lp["wq"]).reshape(b, w, cfg.n_head, cfg.d_head)
        k = (h @ lp["wk"]).reshape(b, w, cfg.n_head, cfg.d_head)
        v = (h @ lp["wv"]).reshape(b, w, cfg.n_head, cfg.d_head)
        cache = cache_ops.write_window(cache, i, k, v, posw, write_mask)
        o = cache_ops.decode_verify(cache, i, q, ctx_len,
                                    sm_scale=cfg.sm_scale)
        x = x + o.reshape(b, w, cfg.d_model) @ lp["wo"]
        x = x + _ffn(_ln(x, lp["ln2_g"], lp["ln2_b"]), lp)
    x = _ln(x, params["lnf_g"], params["lnf_b"])
    return x @ params["tok_emb"].T, cache


class DecoderLM(nn.Module):
    """The serving contract (serving.engine.ServingEngine's ``model``): a
    config plus its parameters, and the three step functions (``verify``
    is the speculative window).

    ``params`` (a mapping as :func:`init_params` returns, e.g. from
    :func:`params_from_jax`) defaults to :func:`init_params` at ``seed``.
    ``device=None`` means the card and raises without one; the parameters
    are moved to the resolved device and never take gradients."""

    def __init__(self, cfg: DecoderConfig, params: Dict = None,
                 seed: int = 0, device=None):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        if params is None:
            params = init_params(cfg, seed, device=self.device)

        def par(t):
            return nn.Parameter(t.to(device=self.device, dtype=cfg.dtype),
                                requires_grad=False)

        self.tok_emb = par(params["tok_emb"])
        self.pos_emb = par(params["pos_emb"])
        self.lnf_g = par(params["lnf_g"])
        self.lnf_b = par(params["lnf_b"])
        self.layers = nn.ModuleList(
            nn.ParameterDict({k: par(lp[k]) for k in _LAYER_KEYS})
            for lp in params["layers"])

    @property
    def params(self) -> Dict:
        """The parameters as the mapping the step functions read."""
        return {"tok_emb": self.tok_emb, "pos_emb": self.pos_emb,
                "lnf_g": self.lnf_g, "lnf_b": self.lnf_b,
                "layers": list(self.layers)}

    def prefill(self, tokens, lengths):
        return prefill_forward(self.params, self.cfg, tokens, lengths)

    def decode(self, cache, cache_ops, tokens, pos, active):
        return decode_forward(self.params, self.cfg, cache, cache_ops,
                              tokens, pos, active)

    def verify(self, cache, cache_ops, tokens, pos, active, write_mask):
        return verify_forward(self.params, self.cfg, cache, cache_ops,
                              tokens, pos, active, write_mask)


def reference_decode(params, cfg: DecoderConfig, prompt,
                     max_new_tokens: int):
    """O(S²) no-cache greedy reference: recompute the FULL causal forward
    for every generated token. The yardstick the incremental paged and
    contiguous decode paths are held against. Returns (tokens list, logits
    list), the logits as float32 numpy rows."""
    dev = params["tok_emb"].device
    seq = [int(t) for t in prompt]
    out_tokens, out_logits = [], []
    for _ in range(max_new_tokens):
        toks = torch.tensor([seq], dtype=torch.long, device=dev)
        lengths = torch.tensor([len(seq)], dtype=torch.int32, device=dev)
        logits, _ = prefill_forward(params, cfg, toks, lengths)
        last = logits[0, len(seq) - 1].float().cpu().numpy()
        nxt = int(np.argmax(last))
        out_tokens.append(nxt)
        out_logits.append(last)
        seq.append(nxt)
        if len(seq) >= cfg.max_seq:
            break
    return out_tokens, out_logits
