"""The flip rule: how two runs of an MoE model are held to each other when
their routers may choose differently at a near tie.

Two implementations (torch and XLA, or the card and the CPU) compute a
token's router probabilities from inputs that differ by rounding. Where
the k-th and (k+1)-th probabilities lie closer together than that
difference can move them, the two may select different experts: a flip.
A flip at a near tie is agreement; any other difference in choice is a
fault. After a flip the two runs part for good: the flipped token's FFN
output differs by O(1), and every later layer at that position and every
later position of its sequence reads it (attention is causal). So:

- each MoE layer call records, per token, the router's input, its
  probabilities and its choice (`record_port_routes`, and the JAX tests'
  own recorder of the reference);
- a flip is *first-order* where no earlier flip of the same sequence, at
  an earlier call and at a position at or before it, can have reached
  its inputs. A first-order flip must lie within `gap_bound` of a tie on
  the reference side (the reference's k-th minus (k+1)-th probability).
  A later flip is a consequence of one of those and is printed, not
  bounded: its inputs differ by what a different expert gave;
- every input no flip can have reached is held within `state_rel` of
  the call's scale, and `clean` tells the caller which logits and ids
  no flip can have reached, to hold them at its own tolerance.

The module imports neither JAX nor the JAX package: the card's tests and
`chip_smoke.py` use it too.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import List, Tuple

import numpy as np
import torch

# A reduced MoE model served on the card and on the CPU from the same
# weights (`chip_smoke.py` and the card's tests), by the weights' dtype:
# the router inputs' and the last logits' tolerance relative to their
# scale (f32 weights still round k and v to bf16 caches; bf16 weights
# round every layer), and the gap to a tie within which a first-order
# flip is agreement. A logit is a sum over d_model of x_d·w_d with
# |x·w| ~ 1, so inputs `rel` of their scale apart move it by about rel
# and a probability by at most a quarter of that, each of the two
# probabilities at the tie: a gap within half of rel, doubled for margin.
CARD_STATE_REL = {"float32": 5e-4, "bfloat16": 3e-2}
CARD_GAP_BOUND = {"float32": 5e-4, "bfloat16": 2.0 ** -5}

# one MoE layer call: router input (N, D) f32, probabilities (N, E),
# choice (N, K), all numpy
Call = Tuple[np.ndarray, np.ndarray, np.ndarray]


def _require(cond: bool, msg) -> None:
    """An AssertionError where `cond` fails, also under `python -O`
    (`chip_smoke.py` runs these checks outside pytest)."""
    if not cond:
        raise AssertionError(msg)


@contextlib.contextmanager
def record_port_routes():
    """Record every call of the port's router (`repro_torch.nn.moe.route`)
    into the list yielded: its input and probabilities in f32 and its
    choice, copied to the host. The router's outputs are untouched."""
    from repro_torch.nn import moe
    orig, log = moe.route, []

    def route(router_params, x_flat, cfg):
        out = orig(router_params, x_flat, cfg)
        probs = torch.softmax(x_flat.float() @ router_params["w"], dim=-1)
        log.append((x_flat.float().cpu().numpy(), probs.cpu().numpy(),
                    out[0].cpu().numpy()))
        return out

    moe.route = route
    try:
        yield log
    finally:
        moe.route = orig


@dataclasses.dataclass
class Flip:
    call: int
    seq: int
    pos: int
    gap: float          # the reference's k-th minus (k+1)-th probability
    first_order: bool
    port: tuple
    ref: tuple


@dataclasses.dataclass
class FlipReport:
    flips: List[Flip]
    max_state_err: float    # over the inputs no flip reached, / their scale
    n_moe: int
    prompt_len: int
    logit_err: float = float("nan")   # `check_served`: the last logits', / scale

    def call_of(self, layer: int, pos: int) -> int:
        """The index of MoE layer `layer`'s call that routes position
        `pos`: the prefill's calls come first, then one group a step."""
        return layer if pos < self.prompt_len else (
            self.n_moe * (1 + pos - self.prompt_len) + layer)

    def clean(self, seq: int, pos: int, call: int) -> bool:
        """Whether no flip of sequence `seq` before call `call` sits at or
        before position `pos`: what that call (or, with `call` past a
        step's last layer, that step's logits) computes at `pos` cannot
        have read a flipped token."""
        return not any(f.seq == seq and f.pos <= pos and f.call < call
                       for f in self.flips)

    def lines(self, name: str) -> List[str]:
        first = [f for f in self.flips if f.first_order]
        out = [f"{name}: {len(self.flips)} flips, {len(first)} first-order, largest "
               f"first-order gap {max((f.gap for f in first), default=0.0):.3g}; "
               f"inputs no flip reached within {self.max_state_err:.3g} of scale"]
        out += [f"{name}: flip at call {f.call} seq {f.seq} pos {f.pos} gap {f.gap:.3g} "
                f"({'first-order' if f.first_order else 'downstream'}): experts "
                f"{f.port} vs reference {f.ref}" for f in self.flips]
        return out


def check_flip_rule(port: List[Call], ref: List[Call], *, batch: int,
                    prompt_len: int, n_moe: int, gap_bound: float,
                    state_rel: float, name: str = "") -> FlipReport:
    """Hold two runs' router calls to each other under the flip rule.
    The calls are a prefill of `batch` x `prompt_len` tokens (n_moe calls
    of batch·prompt_len tokens, sequence-major), then decode steps (n_moe
    calls of `batch` tokens each). Raises AssertionError on a first-order
    flip above `gap_bound` or an input no flip reached that is more than
    `state_rel` of its call's scale apart."""
    _require(len(port) == len(ref), (name, len(port), len(ref)))
    rep = FlipReport([], 0.0, n_moe, prompt_len)
    for c, ((xp, pp, ip), (xr, pr, ir)) in enumerate(zip(port, ref)):
        N, k = ir.shape
        _require(xp.shape == xr.shape and ip.shape == ir.shape, (name, c))
        if c < n_moe:
            seq, pos = np.divmod(np.arange(N), prompt_len)
        else:
            _require(N == batch, (name, c, N))
            seq, pos = np.arange(N), np.full(N, prompt_len + (c - n_moe) // n_moe)
        clean = np.array([rep.clean(int(s), int(p), c) for s, p in zip(seq, pos)])
        srt = -np.sort(-pr, axis=-1)
        gap = srt[:, k - 1] - srt[:, k]
        differ = (np.sort(ip, -1) != np.sort(ir, -1)).any(-1)
        for n in np.flatnonzero(differ):
            f = Flip(c, int(seq[n]), int(pos[n]), float(gap[n]), bool(clean[n]),
                     tuple(int(e) for e in ip[n]), tuple(int(e) for e in ir[n]))
            _require(not f.first_order or f.gap <= gap_bound,
                     f"{name}: a first-order flip {gap[n]:.3g} from a tie (bound "
                     f"{gap_bound}): {f}")
            rep.flips.append(f)
        if clean.any():
            scale = max(float(np.abs(xr).max()), 1e-30)
            err = float(np.abs(xp[clean] - xr[clean]).max()) / scale
            _require(err <= state_rel,
                     f"{name}: call {c}: router inputs no flip reached differ by "
                     f"{err:.3g} of scale (limit {state_rel})")
            rep.max_state_err = max(rep.max_state_err, err)
    return rep


def check_served(card, cpu, card_log, cpu_log, *, n_moe: int, dtype: str,
                 name: str = "") -> FlipReport:
    """Hold a serve on the card (`card`, a `ServeResult`, and its router
    calls) to the same serve on the CPU under the flip rule: greedy ids
    wherever no flip reached them, bitwise; the last logits of every
    sequence no flip reached within CARD_STATE_REL of their scale."""
    B, S, T = cpu.batch, cpu.prompt_len, cpu.tokens
    rep = check_flip_rule(card_log, cpu_log, batch=B, prompt_len=S, n_moe=n_moe,
                          gap_bound=CARD_GAP_BOUND[dtype],
                          state_rel=CARD_STATE_REL[dtype], name=name)
    for b in range(B):
        for j in range(T + 1):   # id j: the prefill's (j 0), then decode step j − 1's
            if rep.clean(b, S - 1 + j, n_moe * (j + 1)):
                _require(int(card.ids[b, j]) == int(cpu.ids[b, j]),
                         f"{name}: sequence {b} id {j}: {card.ids[b].tolist()} vs "
                         f"{cpu.ids[b].tolist()}")
    rows = [b for b in range(B) if rep.clean(b, S - 1 + T, n_moe * (T + 1))]
    if rows:
        want = cpu.last_logits[rows]
        err = (card.last_logits.cpu()[rows] - want).abs().max().item()
        scale = want.abs().max().item()
        _require(err <= CARD_STATE_REL[dtype] * scale,
                 f"{name}: last logits {err} apart (scale {scale})")
        rep.logit_err = err / scale
    return rep
