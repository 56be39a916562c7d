"""Token marks -> per-output-byte decode state and the block certificate.

Port of the TPU kernel ``lz4net_tpu/ops/records_kernel.py:
records_to_state``.  The CUDA kernels are ``csrc/records_kernel.cu`` (a
scan over the tokens, then a tile expansion over the output bytes, both
launched by one call; its header says what bounds it on the H100 and
what the design does about that); ``records_to_state_reference`` is its
plain PyTorch version.

For every output byte o (in the domain [0, Dt), whose first P positions
are a dictionary prefix) the governing sequence is the last token whose
output start ``estart`` is <= o.  Outputs:

* ``t0m`` [B, Dt]: the match source of o (RLE overlap collapsed with a
  remainder), or ``VFLAG`` where o is not a match byte;
* ``cidx`` [B, Dt]: the compressed index of o's literal byte, -1 where o
  is not a literal;
* ``stats`` [B, 8]: (n_seqs, total_out, strict, consumed, needed, 0, 0,
  0) - the hardened decoder's certificate.  Columns 5-7 held the TPU
  kernel's window-miss diagnostics; exact reads cannot miss;
* ``ends`` [B, 4], written where the caller passes it: the positions the
  reference decoders' block-end rules bind on, at the block's last
  sequence with a match (its token is the last but one): its literal end
  in the compressed block, its literal end and its match end in the
  output (from P), and the final token's offset where that match's
  length takes extension bytes (else ``NO_END``); ``NO_END`` throughout
  for a block of fewer than two tokens.  Exact wherever the certificate
  holds (``ops/decode_vector.py`` applies the rules).

``mark`` must hold 0/1 values and ``estart`` must never decrease (as
``parse_tokens``' output gives).
"""

from __future__ import annotations

import torch

from .. import _build

TILE = 4096          # the kernel's scan tile; C must be a multiple
EXPAND = 4096        # output bytes of an expansion tile
M17 = (1 << 17) - 1
VFLAG = 1 << 19
NO_END = -(1 << 30)  # ends of a block without a match: below any bound

launches = 0


def _check(comp, mark, ll_all, ml_all, comp_len, out_len, pre_len, C):
    for t in (comp, mark, ll_all, ml_all, comp_len, out_len, pre_len):
        if t.dtype != torch.int32 or t.device != comp.device:
            raise TypeError("all inputs must be int32 on one device")
    B = comp.shape[0]
    if C % TILE or any(t.shape != (B, C) for t in (comp, mark, ll_all,
                                                   ml_all)):
        raise ValueError(f"comp/mark/ll/ml must be [B, C], C % {TILE} == 0")
    if any(t.shape != (B,) for t in (comp_len, out_len, pre_len)):
        raise ValueError("comp_len/out_len/pre_len must be [B]")


def scratch_words(B: int, C: int, Dt: int) -> int:
    """int32 words of the kernels' scratch: the token tables [B, 4, C],
    the scan's look-back words (two per segment of TILE positions), its
    certificate partials [B, 8] and segment counter, and the tile index
    [B, Dt / EXPAND rounded up]."""
    return B * (4 * C + 2 * (C // TILE) + 8 + -(-Dt // EXPAND)) + 1


def _aligned(t):
    """``t`` contiguous from a 16-byte boundary (the kernel's int4 loads)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def records_to_state(comp, mark, ll_all, ml_all, comp_len, out_len,
                     pre_len, C: int, Dt: int, P: int = 0, ends=None):
    """Returns (t0m [B, Dt], cidx [B, Dt], stats [B, 8]), all int32, and
    writes the block-end positions into ``ends`` if given (a contiguous
    [B, 4] int32 tensor on the inputs' device)."""
    global launches
    _check(comp, mark, ll_all, ml_all, comp_len, out_len, pre_len, C)
    if ends is not None and (ends.dtype != torch.int32
                             or ends.shape != (comp.shape[0], 4)
                             or ends.device != comp.device
                             or not ends.is_contiguous()):
        raise ValueError("ends must be a contiguous [B, 4] int32 tensor "
                         "on comp's device")
    if comp.device.type == "cpu":
        return records_to_state_reference(comp, mark, ll_all, ml_all,
                                          comp_len, out_len, pre_len, C,
                                          Dt, P, ends)
    if comp.device.type != "cuda":
        raise ValueError(f"unsupported device {comp.device}")
    ins = [_aligned(t) for t in (comp, mark, ll_all, ml_all, comp_len,
                                 out_len, pre_len)]
    B = comp.shape[0]
    t0m = torch.empty((B, Dt), dtype=torch.int32, device=comp.device)
    cidx = torch.empty_like(t0m)
    stats = torch.empty((B, 8), dtype=torch.int32, device=comp.device)
    tok = torch.empty(scratch_words(B, C, Dt), dtype=torch.int32,
                      device=comp.device)
    _build.launch("lz4t_records_to_state", comp.device,
                  *(t.data_ptr() for t in ins),
                  t0m.data_ptr(), cidx.data_ptr(), stats.data_ptr(),
                  None if ends is None else ends.data_ptr(),
                  tok.data_ptr(), B, C, Dt, P)
    launches += 1
    return t0m, cidx, stats


def records_to_state_reference(comp, mark, ll_all, ml_all, comp_len,
                               out_len, pre_len, C: int, Dt: int,
                               P: int = 0, ends=None):
    """Plain PyTorch version of ``records_to_state`` (same outputs)."""
    i32 = torch.int32
    dev = comp.device
    B = comp.shape[0]
    q = torch.arange(C, dtype=i32, device=dev).expand(B, C)
    ll = ll_all.clamp(0, Dt)
    ml = ml_all.clamp(0, Dt)
    m1 = mark == 1

    lit_nib = comp >> 4
    hdr = 1 + torch.where((lit_nib == 15) & m1,
                          1 + (ll - 15).clamp(min=0) // 255, 0)
    adv = mark * (ll + ml)
    estart = P + torch.cumsum(adv, 1, dtype=i32) - adv
    rank = torch.cumsum(mark, 1, dtype=i32)
    n_seqs = rank[:, -1]

    nxt = torch.cat([comp[:, 1:], torch.zeros_like(comp[:, :1])], dim=1)
    off16 = comp | (nxt << 8)
    mpos = (q + hdr + ll).clamp(0, C - 2)
    off = torch.gather(off16, 1, mpos.long())

    out_lim = P + out_len[:, None]
    ref_floor = P - pre_len[:, None]
    match_dst = estart + ll
    lok = m1 & (ll > 0) & (estart < out_lim)
    mok = m1 & (match_dst < out_lim) & (off > 0) \
        & (match_dst - off >= ref_floor)

    # ---- hardened-decoder certificate ----
    end_s = torch.where(m1, q + hdr + ll, 0)
    consumed = end_s.amax(1)
    has_match = m1 & (rank < n_seqs[:, None])
    needed = (torch.where(m1, ll, 0)
              + torch.where(has_match, ml, 0)).sum(1, dtype=i32)
    total_out = (torch.where(m1 & (estart < out_lim), ll, 0)
                 + torch.where(mok, ml, 0)).sum(1, dtype=i32)
    lit_in = (~m1 | (q + hdr + ll <= comp_len[:, None])).all(1)
    m_valid = (~has_match | ((off > 0) & (match_dst - off >= ref_floor))
               ).all(1)
    strict = lit_in & m_valid & (consumed == comp_len) & (n_seqs > 0)

    # ---- per output byte: the last token with estart <= o ----
    tokq = torch.cummax(torch.where(m1, q, -1), dim=1).values   # fill fwd
    tokc = tokq.clamp(min=0).long()
    key = torch.where(tokq >= 0, torch.gather(estart, 1, tokc), -1)
    o = torch.arange(Dt, dtype=i32, device=dev).expand(B, Dt).contiguous()
    at = torch.searchsorted(key.contiguous(), o, right=True) - 1
    found = at >= 0
    atc = at.clamp(min=0)
    tq = torch.gather(tokq, 1, atc)
    found = found & (tq >= 0)
    tqc = tq.clamp(min=0).long()

    def field(x):
        return torch.gather(x, 1, tqc)

    estq = field(estart)
    llq = field(ll).clamp(max=M17)
    offq = field(off)
    mdst = estq + llq
    in_lit = found & field(lok) & (o < mdst)
    in_match = found & ~in_lit & field(mok) & (o >= mdst)
    hdrq = 1 + torch.where(llq >= 15, 1 + (llq - 15).clamp(min=0) // 255, 0)
    cidx = torch.where(in_lit, tq + hdrq + (o - estq), -1)
    phase = o - mdst
    msrc = torch.where(in_match & (phase >= offq),
                       mdst - offq + torch.fmod(phase, offq.clamp(min=1)),
                       o - offq)
    t0m = torch.where(in_match, msrc.clamp(0, Dt - 1), VFLAG)

    stats = torch.zeros((B, 8), dtype=i32, device=dev)
    stats[:, 0] = n_seqs
    stats[:, 1] = total_out
    stats[:, 2] = strict.to(i32)
    stats[:, 3] = consumed
    stats[:, 4] = needed
    if ends is not None:
        # the last token with a match (rank n_seqs - 1) and the final one
        qm = torch.where(m1 & (rank == n_seqs[:, None] - 1), q, -1).amax(1)
        qf = torch.where(m1 & (rank == n_seqs[:, None]), q, -1).amax(1)
        at = qm.clamp(min=0).long()[:, None]
        llq = torch.gather(ll, 1, at)[:, 0].clamp(max=M17)
        hdrq = 1 + torch.where(llq >= 15, 1 + (llq - 15) // 255, 0)
        mdst = torch.gather(estart, 1, at)[:, 0] + llq
        ext = torch.gather(comp, 1, at)[:, 0] & 15 == 15
        got = torch.stack([qm + hdrq + llq, mdst - P,
                           torch.gather(estart, 1, qf.clamp(min=0).long()[
                               :, None])[:, 0] - P,
                           torch.where(ext, qf, NO_END)], 1)
        ends.copy_(torch.where((n_seqs >= 2)[:, None], got, NO_END))
    return t0m.to(i32), cidx.to(i32), stats
