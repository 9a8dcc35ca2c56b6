"""Attention-LSTM caption decoder ("Show, Attend and Tell").

Port of ``ppvision_tpu/models/captioner.py`` (reference
``DecoderWithAttention`` / ``Attention``, ``Image_Caption/models.py:57-218``)
under the reference's state_dict names: ``attention.encoder_att``,
``attention.decoder_att``, ``attention.full_att``, ``embedding``,
``decode_step`` (an ``LSTMCell``, gate order i, f, g, o), ``init_h``,
``init_c``, ``f_beta`` and ``fc``.

- The teacher-forced decode is a loop over time with an active-row mask,
  as the JAX scan has it, not the reference's shrinking sorted batch:
  inactive rows keep their ``h, c``; the vocab head and dropout run once
  on the stacked states after the loop; predictions and alphas of
  inactive steps are zero.  The loop stops after the longest caption;
  the steps after it would only add masked zeros.
- ``att_enc(enc)`` is computed once, outside the loop, and the attention
  context is a batched matmul of the weights with the features (the
  weighted features are never materialized).
- Beam search decodes the B*k beams of a batch in one loop with a fixed
  budget of ``max_steps`` steps, finished-beam masking and -1e9 scores;
  ``topk`` runs over each image's flat (k*V) scores.
- Dropout draws its mask from an explicit ``torch.Generator``, as Flax's
  ``nn.Dropout`` (keep with probability 1 - p, scale by 1 / (1 - p)).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["AttentionLSTMDecoder", "DecoderOutput", "beam_search", "beam_search_batch", "caption_loss",
           "init_decoder_"]


class DecoderOutput(NamedTuple):
    predictions: torch.Tensor  # (B, T, vocab)
    alphas: torch.Tensor  # (B, T, num_pixels)
    decode_lengths: torch.Tensor  # (B,) = caption_lengths - 1


class Attention(nn.Module):
    def __init__(self, encoder_dim: int, decoder_dim: int, attention_dim: int):
        super().__init__()
        self.encoder_att = nn.Linear(encoder_dim, attention_dim)
        self.decoder_att = nn.Linear(decoder_dim, attention_dim)
        self.full_att = nn.Linear(attention_dim, 1)


def dropout(x: torch.Tensor, p: float, generator: torch.Generator | None) -> torch.Tensor:
    """Flax ``nn.Dropout(p)`` with its mask drawn from ``generator``."""
    if p == 0.0:
        return x
    keep = 1.0 - p
    mask = torch.rand(x.shape, generator=generator, device=x.device, dtype=x.dtype) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


class AttentionLSTMDecoder(nn.Module):
    """Additive attention over encoder pixels + gated LSTM decoding."""

    def __init__(self, vocab_size: int, embed_dim: int = 512, decoder_dim: int = 512,
                 attention_dim: int = 512, encoder_dim: int = 2048, dropout: float = 0.5):
        super().__init__()
        self.vocab_size = vocab_size
        self.encoder_dim = encoder_dim
        self.dropout = dropout
        self.attention = Attention(encoder_dim, decoder_dim, attention_dim)
        self.embedding = nn.Embedding(vocab_size, embed_dim)
        self.decode_step = nn.LSTMCell(embed_dim + encoder_dim, decoder_dim)
        self.init_h = nn.Linear(encoder_dim, decoder_dim)
        self.init_c = nn.Linear(encoder_dim, decoder_dim)
        self.f_beta = nn.Linear(decoder_dim, encoder_dim)
        self.fc = nn.Linear(decoder_dim, vocab_size)

    def attend(self, enc: torch.Tensor, h: torch.Tensor, enc_proj: torch.Tensor):
        """Additive attention (models.py:75-89): enc (B, P, E), its
        projection (B, P, A), h (B, D) or (B, k, D) for k beams an image.
        Returns the context (h's leading shape, E) and alpha (.., P)."""
        att = self.attention
        h3 = h if h.ndim == 3 else h[:, None]
        e = F.relu(enc_proj[:, None] + att.decoder_att(h3)[:, :, None])  # (B, k, P, A)
        alpha = torch.softmax(att.full_att(e)[..., 0], dim=-1)  # (B, k, P)
        ctx = torch.matmul(alpha, enc)  # (B, k, E)
        if h.ndim == 2:
            return ctx[:, 0], alpha[:, 0]
        return ctx, alpha

    def lstm_step(self, x: torch.Tensor, h: torch.Tensor, c: torch.Tensor):
        """torch LSTMCell semantics, gate order (i, f, g, o), with the two
        products summed as the JAX package's two Dense layers."""
        cell = self.decode_step
        gates = F.linear(x, cell.weight_ih, cell.bias_ih) + F.linear(h, cell.weight_hh, cell.bias_hh)
        i, f, g, o = gates.chunk(4, dim=-1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return torch.sigmoid(o) * torch.tanh(c_new), c_new

    def init_state(self, enc: torch.Tensor):
        mean = enc.mean(dim=1)
        return self.init_h(mean), self.init_c(mean)

    def step(self, enc, emb_t, h, c, enc_proj):
        """One decode step without the vocab head: attention -> gate ->
        LSTM.  Returns (h, c, alpha)."""
        ctx, alpha = self.attend(enc, h, enc_proj)
        gate = torch.sigmoid(self.f_beta(h))
        h, c = self.lstm_step(torch.cat([emb_t, gate * ctx], dim=-1), h, c)
        return h, c, alpha

    def forward(
        self,
        encoder_out: torch.Tensor,  # (B, S, S, E) or (B, P, E)
        captions: torch.Tensor,  # (B, L) token ids
        caption_lengths: torch.Tensor,  # (B,)
        generator: torch.Generator | None = None,
    ) -> DecoderOutput:
        """Teacher-forced decode.  Dropout runs in training mode, its mask
        drawn from ``generator``."""
        b = encoder_out.shape[0]
        enc = encoder_out.reshape(b, -1, self.encoder_dim)
        decode_lengths = caption_lengths.to(enc.device) - 1
        max_t = captions.shape[1] - 1
        steps = min(max_t, max(int(decode_lengths.max()), 0))

        embeddings = self.embedding(captions.to(enc.device).long())  # (B, L, emb)
        h, c = self.init_state(enc)
        enc_proj = self.attention.encoder_att(enc)  # hoisted out of the decode loop
        hs, alphas = [], []
        for t in range(steps):
            active = (t < decode_lengths)[:, None].to(enc.dtype)
            h_new, c_new, alpha = self.step(enc, embeddings[:, t], h, c, enc_proj)
            # Inactive rows keep their state and emit zeros.
            h = active * h_new + (1 - active) * h
            c = active * c_new + (1 - active) * c
            hs.append(h_new)
            alphas.append(alpha * active)
        if steps < max_t:  # every caption has ended: the rest is masked away
            pad = max_t - steps
            hs.extend([torch.zeros_like(h)] * pad)
            alphas.extend([enc.new_zeros(b, enc.shape[1])] * pad)
        hs_t = torch.stack(hs, dim=1)  # (B, T, D)
        p = self.dropout if self.training else 0.0
        preds = self.fc(dropout(hs_t, p, generator))
        active = (torch.arange(max_t, device=enc.device)[None, :] < decode_lengths[:, None]).to(preds.dtype)
        return DecoderOutput(
            predictions=preds * active[..., None],
            alphas=torch.stack(alphas, dim=1),
            decode_lengths=decode_lengths,
        )


def init_decoder_(decoder: AttentionLSTMDecoder, seed: int) -> AttentionLSTMDecoder:
    """The reference's init from a seed: the embedding and ``fc``'s weight
    U(-0.1, 0.1), ``fc``'s bias 0 (models.py:127-133); every other weight
    and bias torch's default U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    g = torch.Generator().manual_seed(seed)

    def uniform_(t: torch.Tensor, bound: float) -> None:
        t.copy_((torch.rand(t.shape, generator=g, dtype=torch.float64) * 2 - 1) * bound)

    with torch.no_grad():
        for m in decoder.modules():
            if isinstance(m, nn.Linear):
                uniform_(m.weight, m.in_features**-0.5)
                uniform_(m.bias, m.in_features**-0.5)
        cell = decoder.decode_step
        for t in (cell.weight_ih, cell.weight_hh, cell.bias_ih, cell.bias_hh):
            uniform_(t, cell.hidden_size**-0.5)
        uniform_(decoder.embedding.weight, 0.1)
        uniform_(decoder.fc.weight, 0.1)
        decoder.fc.bias.zero_()
    return decoder


def caption_loss(out: DecoderOutput, captions: torch.Tensor, alpha_c: float = 1.0):
    """(cross-entropy, doubly-stochastic regularizer, top5-accuracy).

    CE averages over valid (packed) tokens only, as the reference's
    pack_padded_sequence + CrossEntropyLoss (train.py:274-286); the
    attention regularizer runs over the full zero-padded alphas, as the
    reference does."""
    preds = out.predictions
    targets = captions[:, 1:].to(preds.device).long()  # (B, T)
    t = preds.shape[1]
    mask = (torch.arange(t, device=preds.device)[None, :] < out.decode_lengths[:, None]).to(preds.dtype)
    logp = torch.log_softmax(preds, dim=-1)
    tok_logp = logp.gather(-1, targets[..., None])[..., 0]
    denom = torch.clamp_min(mask.sum(), 1.0)
    ce = -(tok_logp * mask).sum() / denom
    dsr = torch.mean((1.0 - out.alphas.sum(dim=1)) ** 2)
    top5 = preds.topk(5, dim=-1).indices  # (B, T, 5)
    hit = (top5 == targets[..., None]).any(dim=-1).to(torch.float32)
    acc5 = 100.0 * (hit * mask).sum() / denom
    return ce, dsr, acc5


@torch.no_grad()
def beam_search_batch(
    decoder: AttentionLSTMDecoder,
    encoder_out: torch.Tensor,  # (B, S, S, E)
    start_token: int,
    end_token: int,
    beam_size: int = 5,
    max_steps: int = 50,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fixed-budget beam search of a batch of images, the B*k beams in one
    loop (the reference loops images one at a time, eval_total.py:96-175;
    identical results per image).  Returns ((B, max_steps) tokens, (B,)
    scores) of each image's best sequence: the best completed one, or the
    best live beam if none completed."""
    b, k = encoder_out.shape[0], beam_size
    enc = encoder_out.reshape(b, -1, decoder.encoder_dim)
    dev = enc.device
    enc_proj = decoder.attention.encoder_att(enc)  # step-invariant
    h0, c0 = decoder.init_state(enc)
    h = h0[:, None].expand(b, k, h0.shape[-1]).contiguous()
    c = c0[:, None].expand(b, k, c0.shape[-1]).contiguous()
    neg_inf = torch.tensor(-1e9, dtype=enc.dtype, device=dev)
    tokens = torch.full((b, k, max_steps), end_token, dtype=torch.long, device=dev)
    prev = torch.full((b, k), start_token, dtype=torch.long, device=dev)
    # All beams start equal: only beam 0 is live at the first step.
    scores = torch.where(torch.arange(k, device=dev) == 0, 0.0, neg_inf).expand(b, k)
    finished = torch.zeros((b, k), dtype=torch.bool, device=dev)
    v = decoder.vocab_size
    only_end = torch.where(torch.arange(v, device=dev) == end_token, 0.0, neg_inf)
    for t in range(max_steps):
        h, c, _ = decoder.step(enc, decoder.embedding(prev), h, c, enc_proj)
        logp = torch.log_softmax(decoder.fc(h), dim=-1)  # (B, k, V)
        # Finished beams may only extend with end_token at zero cost.
        logp = torch.where(finished[..., None], only_end, logp)
        total = (scores[..., None] + logp).reshape(b, k * v)
        scores, top_idx = total.topk(k, dim=-1)
        beam_idx, tok = top_idx // v, top_idx % v
        tokens = tokens.gather(1, beam_idx[..., None].expand(b, k, max_steps))
        parent_fin = finished.gather(1, beam_idx)
        # Record the new token at position t for unfinished parents.
        tokens[:, :, t] = torch.where(parent_fin, tokens[:, :, t], tok)
        finished = parent_fin | (tok == end_token)
        h = h.gather(1, beam_idx[..., None].expand_as(h))
        c = c.gather(1, beam_idx[..., None].expand_as(c))
        prev = tok
    best = scores.argmax(dim=-1)
    rows = torch.arange(b, device=dev)
    return tokens[rows, best], scores[rows, best]


def beam_search(decoder, encoder_out, start_token: int, end_token: int, beam_size: int = 5,
                max_steps: int = 50) -> tuple[torch.Tensor, torch.Tensor]:
    """``beam_search_batch`` of one image, (1, S, S, E): (max_steps,)
    tokens and the score."""
    tokens, scores = beam_search_batch(decoder, encoder_out, start_token, end_token, beam_size, max_steps)
    return tokens[0], scores[0]
