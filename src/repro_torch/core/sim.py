"""Protocol-simulator driver (port of ``repro.core.sim``): the paper's
evaluation figures (Figs 1-5, 11-15, 20-21).

``run_sim`` advances the vectorized client state machines of
``core.protocol`` over ``SimParams.ticks`` microseconds and returns the
throughput / latency / I/O statistics the paper plots.

On a card the ticks run as CUDA graphs: ``TickGraph`` captures
``GRAPH_TICKS`` consecutive ticks once, over state buffers allocated once
(the tick ``t`` included, as a device scalar the graph advances), and
``advance`` replays it ``ticks // GRAPH_TICKS`` times, then a graph of the
remaining ticks once.  Nothing in a tick waits for the host, and
``run_sim`` reads the counters once, after the last replay.  A capture that
fails raises: the card never falls back to eager ticks unless the caller
asks for them (``graph=False``).  On the CPU the same ``tick`` runs eagerly,
tick by tick; that is the plain version the tests hold to the reference.

Launch counters count a kernel where it is captured, so a kernel's launches
in a graphed run are its captured launches times the graph's replays:
``TickGraph.captured`` and ``TickGraph.replays`` (pass ``record=[]`` to
collect the graphs of a run).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.protocol import COUNTERS, DEAD, SimState, sim_init, tick
from repro_torch.core.simnet import NetState, SimParams
from repro_torch.core.types import SyncMode, as_device
from repro_torch.kernels.wc_combine import ops as wc_ops
from repro_torch.workloads.ycsb import WORKLOADS, WorkloadSpec, generate_ops

__all__ = ["SimParams", "SimResult", "make_streams", "run_sim",
           "sweep_clients", "initial_state", "advance", "TickGraph",
           "GRAPH_TICKS"]

_I32 = torch.int32
GRAPH_TICKS = 64          # ticks captured, unrolled, into one CUDA graph
# the launch counters of the kernels a tick runs (wc_combine: the ENQ
# ticket rank and issue_mn's per-address rank)
_KERNEL_COUNTERS = (wc_ops.counter,)


@dataclasses.dataclass
class SimResult:
    mode: str
    n_clients: int
    ticks: int
    ops_done: int
    throughput_mops: float      # completed ops / simulated microsecond
    p50_us: float
    p99_us: float
    retries: int                # redundant CAS / lock polls (Fig 1)
    mn_iops_used: int           # total MN verbs
    cn_msgs: int
    wc_rate: float              # combined / writes (Fig 4, 21)
    wc_rate_local: float
    wc_rate_global: float
    avg_batch: float            # mean WC batch size (Fig 21)
    pess_ratio: float           # pessimistic writes / writes (Fig 14)
    ideal_pess_ratio: float     # writes with >= threshold retries / writes
    deadlocks: int

    def row(self) -> str:
        return (f"{self.mode},{self.n_clients},{self.throughput_mops:.4f},"
                f"{self.p50_us:.1f},{self.p99_us:.1f},{self.retries},"
                f"{self.wc_rate:.3f},{self.avg_batch:.2f},{self.pess_ratio:.3f}")


def make_streams(p: SimParams, spec: WorkloadSpec, n_keys: int,
                 theta: float | None = None, seed: int = 0,
                 device: str | torch.device = "cuda") -> dict:
    """Pre-generate per-lane op streams with pre-hashed table slots: four
    contiguous ``(n_lanes, max_ops)`` int32 tensors on ``device``."""
    dev = as_device(device)
    n, m = p.n_lanes, p.max_ops
    ops = generate_ops(spec, n * m, n_keys, n, seed=seed, theta=theta)
    kinds = ops.kinds.reshape(m, n).T.astype(np.int32)
    keys = ops.keys.reshape(m, n).T
    h = ((keys * 2654435761) >> 7) & ((1 << p.h_bits) - 1)
    hc = ((keys * 0x85EBCA6B) >> 5) & ((1 << p.hc_bits) - 1)
    hl = ((keys * 0xC2B2AE35) >> 4) & ((1 << p.hl_bits) - 1)
    return {name: torch.as_tensor(np.ascontiguousarray(a, np.int32),
                                  device=dev)
            for name, a in (("kinds", kinds), ("hkey", h), ("hc", hc),
                            ("hl", hl))}


def _state_map(fn, *states: SimState) -> SimState:
    """``fn`` over the tensors of one or more states, field by field."""
    out = {}
    for f in dataclasses.fields(SimState):
        vals = [getattr(s, f.name) for s in states]
        if f.name == "net":
            out["net"] = NetState(**{
                g.name: fn(*(getattr(v, g.name) for v in vals))
                for g in dataclasses.fields(NetState)})
        else:
            out[f.name] = fn(*vals)
    return SimState(**out)


def _ticks(p, mode, streams, state: SimState, t: torch.Tensor, n: int,
           into: SimState, t_into: torch.Tensor) -> None:
    """``n`` ticks from ``(state, t)``, the result copied into ``into`` and
    ``t_into`` (which may be ``state`` and ``t`` themselves)."""
    for _ in range(n):
        state = tick(p, mode, streams, state, t)
        t = t + 1
    _state_map(lambda dst, src: dst.copy_(src), into, state)
    t_into.copy_(t)


class TickGraph:
    """``n`` consecutive ticks of one ``(p, mode)`` program, captured once
    into a CUDA graph that reads and writes ``state`` and ``t`` in place.

    The capture is preceded by one eager tick on copies of the state (on a
    side stream), which loads every kernel the tick launches.
    ``captured`` holds each kernel's launches recorded in the graph;
    ``replays`` counts ``replay`` calls."""

    def __init__(self, p: SimParams, mode: SyncMode, streams: dict,
                 state: SimState, t: torch.Tensor, n: int):
        dev = t.device
        # the graph reads and writes these by address: keep them alive
        self.state, self.t, self.streams, self.n = state, t, streams, n
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            scratch = _state_map(torch.clone, state)
            t_scratch = t.clone()
            _ticks(p, mode, streams, scratch, t_scratch, 1, scratch,
                   t_scratch)
        torch.cuda.current_stream(dev).wait_stream(side)
        del scratch, t_scratch
        before = [c.count for c in _KERNEL_COUNTERS]
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            _ticks(p, mode, streams, state, t, n, state, t)
        self.captured = {c.name: c.count - b
                         for c, b in zip(_KERNEL_COUNTERS, before)}
        self.replays = 0

    def replay(self) -> None:
        self.graph.replay()
        self.replays += 1


def advance(p: SimParams, mode: SyncMode, streams: dict, state: SimState,
            t0: int, ticks: int, *, graph: bool | None = None,
            record: list | None = None) -> SimState:
    """Ticks ``t0 .. t0 + ticks - 1`` from ``state`` (left unchanged).

    ``graph``: None = CUDA graphs on a card, eager ticks on the CPU; False
    = eager ticks on any device; True = graphs (a card only).  The graphs
    used are appended to ``record`` when it is a list."""
    dev = state.phase.device
    use_graph = dev.type == "cuda" if graph is None else graph
    if use_graph and dev.type != "cuda":
        raise ValueError("advance: CUDA graphs need a CUDA device; the CPU "
                         "runs the ticks eagerly (graph=None or False)")
    t = torch.full((), t0, dtype=_I32, device=dev)
    if not use_graph:
        for _ in range(ticks):
            state = tick(p, mode, streams, state, t)
            t = t + 1
        return state
    state = _state_map(torch.clone, state)      # the graphs' static buffers
    full, rest = divmod(ticks, GRAPH_TICKS)
    for n, reps in ((GRAPH_TICKS, full), (rest, 1)):
        if n == 0 or reps == 0:
            continue
        g = TickGraph(p, mode, streams, state, t, n)
        for _ in range(reps):
            g.replay()
        if record is not None:
            record.append(g)
    return state


def initial_state(p: SimParams, streams: dict, n_active: int) -> SimState:
    """The state before tick 0 with the lanes ``>= n_active`` dead."""
    state = sim_init(p, streams)
    ids = torch.arange(p.n_lanes, dtype=_I32, device=state.phase.device)
    state.phase = torch.where(ids < int(n_active), state.phase, DEAD)
    return state


def _run(p: SimParams, mode: SyncMode, streams: dict, n_active: int, *,
         graph: bool | None = None, record: list | None = None) -> SimState:
    """The whole run: ``p.ticks`` ticks from ``initial_state`` (graphed on
    a card, see ``advance``)."""
    return advance(p, mode, streams, initial_state(p, streams, n_active), 0,
                   p.ticks, graph=graph, record=record)


def _pct(hist: np.ndarray, q: float) -> float:
    c = np.cumsum(hist)
    if c[-1] == 0:
        return float("nan")
    return float(np.searchsorted(c, q * c[-1]))


def run_sim(p: SimParams, mode: SyncMode, streams: dict, n_clients: int, *,
            record: list | None = None) -> SimResult:
    """One simulated run of ``n_clients`` closed-loop clients on the device
    of ``streams``; the counters come to the host once, at the end."""
    return _result(p, mode, n_clients,
                   _run(p, mode, streams, n_clients, record=record))


def _result(p: SimParams, mode: SyncMode, n_clients: int, s: SimState
            ) -> SimResult:
    """The ``SimResult`` of a finished run's state (one copy to the host)."""
    host = torch.cat([s.verbs] + [getattr(s, c).reshape(1) for c in COUNTERS]
                     + [s.hist]).cpu().numpy()
    verbs = host[:5]
    c = dict(zip(COUNTERS, (int(x) for x in host[5:5 + len(COUNTERS)])))
    hist = host[5 + len(COUNTERS):]
    done_w = max(c["done_w"], 1)
    comb = c["comb_g"] + c["comb_l"]
    return SimResult(
        mode=mode.name, n_clients=n_clients, ticks=p.ticks,
        ops_done=c["done"], throughput_mops=c["done"] / p.ticks,
        p50_us=_pct(hist, 0.50), p99_us=_pct(hist, 0.99),
        retries=c["retries"],
        mn_iops_used=int(verbs[:4].sum()), cn_msgs=int(verbs[4]),
        wc_rate=comb / done_w,
        wc_rate_local=c["comb_l"] / done_w,
        wc_rate_global=c["comb_g"] / done_w,
        avg_batch=float(c["batch_sum"] / max(c["batch_cnt"], 1)),
        pess_ratio=c["pess_w"] / done_w,
        ideal_pess_ratio=c["hot_ideal"] / done_w,
        deadlocks=c["deadlocks"],
    )


def sweep_clients(p: SimParams, modes, workload: str, n_keys: int,
                  client_counts, theta: float | None = None, seed: int = 0,
                  device: str | torch.device = "cuda") -> list[SimResult]:
    spec = WORKLOADS[workload]
    streams = make_streams(p, spec, n_keys, theta=theta, seed=seed,
                           device=device)
    out = []
    for mode in modes:
        for nc in client_counts:
            out.append(run_sim(p, mode, streams, nc))
    return out
