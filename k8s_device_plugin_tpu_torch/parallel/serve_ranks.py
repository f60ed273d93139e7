"""The ranks of one serving daemon: rank 0 serves, the others follow.

The reference's engine is one JAX program over a mesh of devices: one
process places the weights (``shard_params_for_tp``) and XLA runs every
device's part of each program. In the port each rank is a process that
holds its part of the model (models/serve_engine.py on a ``dp x tp``
mesh), and the programs must run on every rank, in one order, with the
same host arguments. So:

- Rank 0 owns everything on the host: HTTP, parsing, the batchers, the
  page tables, prefix index and request queues, tokenization and
  metrics. Its engine is a ``Leader``: every engine method that touches
  device state (marked ``@mirrored`` in models/serve_engine.py, which
  lists them in ``MIRRORED``) is sent to every follower, under one lock,
  before it runs, with its host arguments. Each KV cache or page pool
  goes by a handle and each ``torch.Generator`` by its state.
- The other ranks bind no port and hold only device state: their weight
  shard and their KV caches and pools. ``follow`` runs each call it
  receives on the rank's own ``LMServer``. The ranks so issue the same
  collectives in the same order, and their KV stays in step with rank
  0's.
- Handles. A cache or pool that a call returns is numbered on every
  rank, in the order of the results, and the number rides on the
  object (``_mirror_handle``). When rank 0 drops one, its next message
  tells the followers to drop theirs.
- Agreement. After every call the ranks exchange a status: whether the
  call raised, and a digest of the integer results (the token ids) that
  are defined (``LMServer.defined_result``, by the method's ``mirrored``
  rule: a paged program's padding rows sample from a scratch page that
  is written in no fixed order). A
  call that every rank finished with the same tokens, or that raised
  the same exception type on every rank (a request refused before any
  device work), leaves the ranks in step. Anything else breaks the
  daemon (``Leader.broken``): the followers raise out of ``follow``,
  and rank 0 runs its ``on_broken`` callbacks (the daemon stops, exit
  1) and refuses every later call. It never carries on with ranks that
  disagree or are missing.
- Two gloo groups over every rank carry this, whatever the backend of
  the model's collectives. ``ctl`` carries the calls; its timeout is a
  year, since the followers wait on it while the daemon is idle (rank
  0's death closes its sockets at once, and the launcher tears the
  ranks down). ``ack`` carries the statuses, with a short timeout
  (``ACK_TIMEOUT_S``). A follower whose call raised while rank 0 waits
  in a collective of the model leaves when the ``ack`` exchange times
  out, and its exit fails rank 0's collective at once.
"""

from __future__ import annotations

import datetime
import hashlib
import logging
import pickle
import threading
import weakref

import numpy as np
import torch
import torch.distributed as dist

from k8s_device_plugin_tpu_torch.models.serve_engine import (
    MIRRORED,
    MIRRORED_ATTRS,
)
from k8s_device_plugin_tpu_torch.models.transformer import KVCache, PagedKV
from k8s_device_plugin_tpu_torch.parallel import comm

log = logging.getLogger("llm-serve")

_IDLE_TIMEOUT = datetime.timedelta(days=365)
ACK_TIMEOUT_S = 120.0


class RanksBroken(RuntimeError):
    """The ranks of the daemon are out of step, or one is gone."""


class _Handle:
    __slots__ = ("n",)

    def __init__(self, n: int):
        self.n = n


class _Gen:
    """A ``torch.Generator`` as its state (a generator cannot be
    pickled; its state can, and a CUDA one's is its seed and offset)."""

    __slots__ = ("cuda", "state")

    def __init__(self, gen: torch.Generator):
        self.cuda = gen.device.type == "cuda"
        self.state = gen.get_state()


def _caches(x):
    """The KV caches and page pools in a call's result, in order."""
    if isinstance(x, (KVCache, PagedKV)):
        yield x
    elif isinstance(x, (tuple, list)):
        for y in x:
            yield from _caches(y)


def _ints(x):
    """The integer content of a result (token ids), as nested lists:
    what every rank must agree on. Floats (logprobs, times) are left
    out."""
    if isinstance(x, torch.Tensor):
        return None if x.is_floating_point() else x.cpu().tolist()
    if isinstance(x, np.ndarray):
        return None if x.dtype.kind == "f" else x.tolist()
    if isinstance(x, (tuple, list)):
        return [_ints(y) for y in x]
    if isinstance(x, (int, np.integer)):
        return int(x)
    return None


def _launches() -> str:
    """This process's B1 and B2 launches so far, as JSON (the stop lines
    of the daemon's log carry them)."""
    import json

    from k8s_device_plugin_tpu_torch.ops import attention, paged_attention

    return json.dumps({c.name: c.launches for c in (
        attention.FLASH_FWD, paged_attention.PAGED_ATTN)})


def _groups(n: int, ack_timeout_s: float) -> tuple:
    """The ``ctl`` and ``ack`` groups over the first ``n`` ranks."""
    members = list(range(n))
    return (dist.new_group(members, backend="gloo", timeout=_IDLE_TIMEOUT),
            dist.new_group(members, backend="gloo",
                           timeout=datetime.timedelta(
                               seconds=ack_timeout_s)))


class Ranks:
    """The two gloo groups of one daemon's ranks (module docstring), over
    the ranks of its mesh (the first ``mesh.world`` of the process
    group). Every rank makes them, in the same place of its startup; a
    rank outside the mesh calls ``idle`` there instead."""

    def __init__(self, mesh, ack_timeout_s: float = ACK_TIMEOUT_S):
        self.rank, self.world = mesh.rank, mesh.world
        self.ctl, self.ack = _groups(mesh.world, ack_timeout_s)

    def send(self, msg) -> None:
        dist.broadcast_object_list([msg], src=0, group=self.ctl)

    def recv(self):
        box = [None]
        dist.broadcast_object_list(box, src=0, group=self.ctl)
        return box[0]

    def agree(self, status) -> list:
        """Every rank's status, on every rank."""
        out = [None] * self.world
        dist.all_gather_object(out, status, group=self.ack)
        return out


def idle(world: int, ack_timeout_s: float = ACK_TIMEOUT_S) -> None:
    """A rank outside a mesh of the first ``world`` ranks takes its part
    in making that mesh's ``Ranks`` groups, as ``new_group`` asks of
    every rank of the process group."""
    _groups(world, ack_timeout_s)


def _status(ints, error) -> tuple:
    if error is not None:
        return ("raised", type(error).__name__)
    return ("ok", hashlib.sha256(repr(ints).encode()).hexdigest())


class Leader:
    """Rank 0's engine: the ``LMServer`` behind it, with every call of
    ``MIRRORED`` (and every set of ``MIRRORED_ATTRS``) sent to the
    followers first and held to their results after (module
    docstring). Any other attribute is the server's own. ``record``
    keeps every message sent in ``log`` and each call's integer results
    in ``results``, for ``replay``."""

    def __init__(self, server, ranks: Ranks, record: bool = False):
        d = self.__dict__
        d["_server"] = server
        d["_ranks"] = ranks
        d["_lock"] = threading.RLock()
        d["_next"] = 0
        d["_dropped"] = []
        d["broken"] = None
        d["stopped"] = False
        d["on_broken"] = []
        d["calls"] = 0
        d["log"] = [] if record else None
        d["results"] = [] if record else None

    def __getattr__(self, name):
        value = getattr(self._server, name)
        if name not in MIRRORED:
            return value

        def call(*args, **kwargs):
            return self._run("call", name, args, kwargs)

        return call

    def __setattr__(self, name, value):
        if name in MIRRORED_ATTRS:
            self._run("set", name, (value,), {})
        else:
            setattr(self._server, name, value)

    def _encode(self, x):
        if isinstance(x, (KVCache, PagedKV)):
            n = getattr(x, "_mirror_handle", None)
            if n is None:
                raise ValueError("a cache not made by an engine call "
                                 "cannot go to the other ranks")
            return _Handle(n)
        if isinstance(x, torch.Generator):
            return _Gen(x)
        if isinstance(x, (tuple, list)):
            return type(x)(self._encode(y) for y in x)
        if isinstance(x, dict):
            return {k: self._encode(v) for k, v in x.items()}
        return x

    def _register(self, out) -> None:
        for c in _caches(out):
            if getattr(c, "_mirror_handle", None) is None:
                n = self.__dict__["_next"]
                c._mirror_handle = n
                self.__dict__["_next"] = n + 1
                weakref.finalize(c, self._dropped.append, n)

    def _run(self, op: str, name: str, args, kwargs):
        with self._lock:
            if self.broken is not None:
                raise RanksBroken(f"serving ranks are out of step: "
                                  f"{self.broken}")
            if self.stopped:
                raise RanksBroken("serving ranks are stopped")
            dropped = []
            while self._dropped:    # appended by finalizers, any thread
                dropped.append(self._dropped.pop())
            msg = {"op": op, "name": name, "args": self._encode(args),
                   "kwargs": self._encode(kwargs), "drop": dropped}
            try:
                self._ranks.send(msg)
            except Exception as e:
                self._break(e)
                raise
            out, ints, error = None, None, None
            try:
                if op == "set":
                    setattr(self._server, name, args[0])
                else:
                    out = getattr(self._server, name)(*args, **kwargs)
                    ints = _ints(self._server.defined_result(
                        name, args, kwargs, out))
            except Exception as e:
                error = e
            mine = _status(ints, error)
            try:
                statuses = self._ranks.agree(mine)
            except Exception as e:
                self._break(error or e)
                raise (error or e) from None
            if any(st != mine for st in statuses):
                self._break(RanksBroken(
                    f"{name}: the ranks disagree: {statuses}"))
                raise self.broken
            self.__dict__["calls"] += 1
            if self.log is not None:
                # a copy: the batcher changes some arguments in place
                # (row lengths) after the call
                self.log.append(pickle.loads(pickle.dumps(msg)))
                self.results.append(ints)
            if error is not None:
                raise error
            self._register(out)
            return out

    @property
    def closed(self) -> bool:
        """Broken or stopped: no engine call will run again."""
        return self.broken is not None or self.stopped

    def _break(self, error) -> None:
        self.__dict__["broken"] = error
        log.error("serving ranks broken: %s", error)
        for fn in self.on_broken:
            try:
                fn()
            except Exception:
                log.exception("on_broken callback failed")

    def stop(self) -> bool:
        """Send every follower a stop; True when every rank ran the same
        number of calls, unbroken. Later calls raise."""
        with self._lock:
            if self.stopped:
                return self.broken is None
            self.__dict__["stopped"] = True
            if self.broken is not None:
                return False
            try:
                self._ranks.send({"op": "stop"})
                counts = self._ranks.agree(self.calls)
            except Exception as e:
                self._break(e)
                return False
        if any(c != self.calls for c in counts):
            log.error("serving ranks ran %s calls", counts)
            return False
        log.info("serving ranks stopped: %d calls each, every one in "
                 "step (rank 0: %d bytes all-reduced in %d all-reduces); "
                 "kernel launches %s", self.calls, comm.REDUCED.bytes,
                 comm.REDUCED.calls, _launches())
        return True


class _Runner:
    """Runs rank 0's messages on another engine: a follower's, or a
    one-device engine that replays a recorded ``Leader.log``."""

    def __init__(self, server):
        self.server = server
        self.objects: dict = {}
        self.numbered = 0

    def _decode(self, x):
        if isinstance(x, _Handle):
            return self.objects[x.n]
        if isinstance(x, _Gen):
            dev = self.server.device if x.cuda else "cpu"
            gen = torch.Generator(device=dev)
            gen.set_state(x.state)
            return gen
        if isinstance(x, (tuple, list)):
            return type(x)(self._decode(y) for y in x)
        if isinstance(x, dict):
            return {k: self._decode(v) for k, v in x.items()}
        return x

    def run(self, msg):
        """(integer results, the exception or None) of one message."""
        for n in msg["drop"]:
            self.objects.pop(n, None)
        try:
            args = self._decode(msg["args"])
            kwargs = self._decode(msg["kwargs"])
            if msg["op"] == "set":
                setattr(self.server, msg["name"], args[0])
                out = ints = None
            else:
                out = getattr(self.server, msg["name"])(*args, **kwargs)
                ints = _ints(self.server.defined_result(
                    msg["name"], args, kwargs, out))
        except Exception as e:
            return None, e
        for c in _caches(out):
            if getattr(c, "_mirror_handle", None) is None:
                c._mirror_handle = self.numbered
                self.objects[self.numbered] = c
                self.numbered += 1
        return ints, None


def follow(server, ranks: Ranks, record: bool = False) -> dict:
    """A follower's loop: run every call rank 0 sends on ``server`` until
    it sends a stop. Returns ``{"calls": n}`` (and ``"results"``, each
    call's integer results, with ``record``). Raises ``RanksBroken``
    when the ranks fall out of step, and whatever broke the channel."""
    runner = _Runner(server)
    calls, results = 0, []
    log.info("rank %d of %d follows rank 0", ranks.rank, ranks.world)
    while True:
        msg = ranks.recv()
        if msg["op"] == "stop":
            ranks.agree(calls)
            break
        ints, error = runner.run(msg)
        if error is not None:
            log.error("rank %d: %s raised %r", ranks.rank, msg["name"],
                      error)
        mine = _status(ints, error)
        statuses = ranks.agree(mine)
        if any(st != mine for st in statuses):
            raise RanksBroken(f"{msg['name']}: the ranks disagree: "
                              f"{statuses}")
        calls += 1
        if record:
            results.append(ints)
    log.info("rank %d stopped after %d calls (%d bytes all-reduced in "
             "%d all-reduces); kernel launches %s", ranks.rank, calls,
             comm.REDUCED.bytes, comm.REDUCED.calls, _launches())
    return {"calls": calls, "results": results} if record \
        else {"calls": calls}


def replay(server, messages) -> list:
    """Each recorded call's integer results on ``server`` (one device):
    the same programs, in the same order, with the same host arguments
    as rank 0 ran (None for a call that raised, as ``Leader.results``
    has it)."""
    runner = _Runner(server)
    return [runner.run(msg)[0] for msg in messages]
