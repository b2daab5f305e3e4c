"""Asynchronous reduction engine over shared-memory windows.

The reference's ``listener_util.Synchronizer`` (ref. mpisppy/utils/
listener_util/listener_util.py:22-327) is the machinery under APH: a
listener thread on every rank periodically Allreduces named summand
vectors while the worker thread solves, so reduction communication
overlaps subproblem compute wall-clock, and workers read whatever global
landed last ("one notch behind", staleness tolerated by design).

TPU-native redesign. Within one chip the reduction is a membership
matmul inside the jitted step — nothing to overlap. The surface where
the listener pattern genuinely survives is ACROSS PROCESSES: scenario
shards living in different host processes (the multi-host deployment
shape, one process per TPU host, summands crossing DCN). MPI's
symmetric Allreduce becomes an asymmetric, wait-free exchange over the
native seqlock windows (ops/native/spwindow):

  - every participant owns one window per named reduction and writes
    ONLY its own summand there (the windows' one-writer discipline);
  - a listener daemon thread per participant beats: publish my latest
    summand -> read every peer's window -> global = sum -> side gigs ->
    sleep(min of everyone's advertised sleep).

No beat ever blocks on a peer: a slow shard simply contributes its last
published summand — exactly the staleness semantics the reference gets
from Allreduce-ing a stale ``local_data`` buffer. Freshness accounting
(which shards are "new enough", ref. aph.py:204-324 enough-fresh check)
stays with the caller, which embeds per-participant timestamps in its
vectors just as APH does.

The worker-facing API mirrors the reference where the semantics match:
``compute_global_data(local_in, global_out, keep_up=...)`` caches the
newest local summand for the listener and copies out the last-reduced
global, with ``keep_up`` folding the caller's newest summand into the
stale global (ref. listener_util.py:164-182). ``quitting`` propagates
through a control window: ANY participant quitting stops every listener
(the reference's summed quitting allreduce, ref. listener_util.py:306).
"""

from __future__ import annotations

import threading
import time

import numpy as np

from ..cylinders.spcommunicator import Window


_CTRL = "_ctrl"          # control reduction: [quitting, sleep_secs]
# dedicated rows for blocking sync_allreduce beats, double-buffered by
# round parity: a peer can be at most one round ahead (round r+1 blocks
# on the OTHER row until everyone arrives), so the row a slow reader is
# still summing is never overwritten mid-round
_SYNC = ("_sync0", "_sync1")


def _augment_lens(names_lens):
    """User reductions + internal rows — the ONE definition of the wire
    layout every participant (thread- or process-mode) must share."""
    lens = dict(names_lens)
    lens[_CTRL] = 2
    for s in _SYNC:
        lens[s] = max(names_lens.values())
    return lens


class Synchronizer:
    """Staleness-tolerant async sum-reductions among N participants.

    Args:
        names_lens: ordered {reduction name: vector length}. Reductions
            are always SUMs (as in the reference, listener_util.py:6).
        n_participants / my_index: the shard group and my slot in it.
        shm_prefix: if given, windows are the native shared-memory
            backend named ``{prefix}.{red}.{participant}`` — participants
            are OS processes. If None, ``windows`` must be supplied
            (thread mode, for tests and in-process wheels).
        windows: optional prebuilt {red: [Window] * n_participants}
            shared by all thread-mode participants.
        sleep_secs: my listener's beat sleep; the group beats at the MIN
            over participants (ref. listener_util.py:308-316).
        listener_gigs: optional {red: (fct, kwargs)} side gigs run by the
            listener after that reduction's global lands, once enabled
            via compute_global_data(enable_side_gig=True)
            (ref. listener_util.py:137-144, 296-303).
    """

    def __init__(self, names_lens, n_participants, my_index, shm_prefix=None,
                 windows=None, sleep_secs=0.01, listener_gigs=None,
                 open_timeout=60.0, ondemand_lens=None):
        self.names_lens = dict(names_lens)
        # on-demand reductions: windows exist, but the LISTENER never
        # touches them — they are summed only when a worker calls
        # reduce_now. For big once-per-iteration payloads (the sharded
        # wheel's full-(W, x) gather: 2·S·K doubles) that would
        # otherwise be republished and re-summed on every ~5 ms beat.
        self.ondemand_lens = dict(ondemand_lens or {})
        assert _CTRL not in self.names_lens
        assert not set(self.ondemand_lens) & set(self.names_lens)
        self.n = int(n_participants)
        self.me = int(my_index)
        self.sleep_secs = float(sleep_secs)
        self.listener_gigs = listener_gigs or {}
        self.enable_side_gig = False
        self.quitting = 0
        self.global_quitting = 0
        self.data_lock = threading.Lock()
        self.local_data = {r: np.zeros(l) for r, l in self.names_lens.items()}
        self.global_data = {r: np.zeros(l) for r, l in self.names_lens.items()}
        self._beats = 0                 # completed listener beats
        self._listener = None

        lens = _augment_lens(self.names_lens)
        lens.update(self.ondemand_lens)
        self._sync_round = 0
        if windows is not None:
            missing = set(lens) - set(windows)
            if missing:
                raise ValueError(
                    f"prebuilt window table is missing {sorted(missing)}; "
                    "thread-mode embedders must size on-demand rows too "
                    "(make_thread_windows(..., ondemand_lens=...))")
            self._windows = windows
        elif shm_prefix is not None:
            self._windows = self._open_shm(shm_prefix, lens, open_timeout)
        else:
            raise ValueError("need shm_prefix (process mode) or windows "
                             "(thread mode)")

    # ---- construction helpers ----
    @staticmethod
    def make_thread_windows(names_lens, n_participants, ondemand_lens=None):
        """One shared window table for an n-thread group (test/in-process
        mode): {red: [Window]*n}. Pass the SAME table to every
        participant's constructor."""
        lens = _augment_lens(names_lens)
        lens.update(ondemand_lens or {})
        return {r: [Window(l) for _ in range(n_participants)]
                for r, l in lens.items()}

    def _open_shm(self, prefix, lens, timeout):
        out = {}
        opened = []                     # (window, i_own_it) for cleanup
        deadline = time.monotonic() + timeout
        try:
            for red, l in lens.items():
                row = []
                for p in range(self.n):
                    name = f"{prefix}.{red}.{p}"
                    if p == self.me:
                        row.append(Window.shared(name, l, create=True))
                    else:
                        while True:
                            try:
                                row.append(
                                    Window.shared(name, l, create=False))
                                break
                            except OSError:
                                if time.monotonic() > deadline:
                                    raise
                                time.sleep(0.05)
                    opened.append((row[-1], p == self.me))
                out[red] = row
        except Exception:
            # don't leak the segments already created/opened: a peer that
            # died mid-startup would otherwise strand /dev/shm entries
            for w, mine in opened:
                w.close(unlink=mine)
            raise
        return out

    def close(self):
        self.quitting = 1
        if self._listener is not None and self._listener.is_alive():
            self._listener.join(timeout=10.0)
            if self._listener.is_alive():
                # a hung listener still put/reads the windows; closing
                # them under it would crash in the native layer instead
                # of failing gracefully (ADVICE r3). Leak the segments
                # (cleanup_shm reaps them) and tell the operator.
                import warnings

                warnings.warn(
                    "Synchronizer.close(): listener thread still alive "
                    "after 10 s join — leaving shm windows open "
                    "(cleanup_shm can reap the segments later)",
                    RuntimeWarning, stacklevel=2)
                return
        for row in self._windows.values():
            for p, w in enumerate(row):
                if hasattr(w, "close"):
                    w.close(unlink=(p == self.me))

    # ---- worker side ----
    def compute_global_data(self, local_in, global_out, enable_side_gig=False,
                            rednames=None, keep_up=False):
        """Cache my newest summands for the listener; copy out the last
        reduced globals. With keep_up, the copied-out global swaps my
        stale contribution for the new one (ref. listener_util.py:164-182:
        "global that is one notch behind" otherwise)."""
        with self.data_lock:
            for red in (rednames if rednames is not None else self.names_lens):
                if keep_up:
                    np.copyto(global_out[red],
                              self.global_data[red] - self.local_data[red]
                              + local_in[red])
                    np.copyto(self.global_data[red], global_out[red])
                else:
                    np.copyto(global_out[red], self.global_data[red])
                np.copyto(self.local_data[red], local_in[red])
        if enable_side_gig:
            # run-once authorization, exactly the reference's contract
            # (ref. listener_util.py:186-190): the SIDE GIG is responsible
            # for clearing ``sync.enable_side_gig = False`` once it has
            # consumed the data; re-enabling before it does is a caller
            # protocol error. Until cleared, the gig re-runs each beat —
            # gigs gate themselves on their own freshness checks
            # (ref. aph.py:204-324 enough-fresh check).
            if self.enable_side_gig:
                raise RuntimeError("side gig already enabled")
            self.enable_side_gig = True

    def publish_now(self, redname, local_vec):
        """Publish my summand of an ON-DEMAND reduction without summing
        (non-consumers of a gather publish only — the read+sum over all
        peers is the consumer's cost, see reduce_now)."""
        self._windows[redname][self.me].put(
            np.asarray(local_vec, dtype=np.float64))

    def reduce_now(self, redname, local_vec, return_min_wid=False):
        """One wait-free sum of an ON-DEMAND reduction (see
        ondemand_lens): publish my summand, read every peer's latest,
        return the sum. Same staleness semantics as the listener
        reductions — a slow peer contributes its last published vector
        — at zero listener-beat cost.

        ``return_min_wid=True`` also returns the minimum peer write-id:
        0 means some peer has NEVER published, i.e. the sum contains
        that peer's zero row — consumers staging the gather for third
        parties (the APH-shard wheel hub) gate on it rather than hand
        out partially-zero data (ADVICE r4)."""
        row = self._windows[redname]
        row[self.me].put(np.asarray(local_vec, dtype=np.float64))
        total = np.zeros(row[self.me].length)
        min_wid = None
        for p in range(self.n):
            vals, wid = row[p].read()
            total += vals
            min_wid = wid if min_wid is None else min(min_wid, wid)
        if return_min_wid:
            return total, min_wid
        return total

    def get_global_data(self, global_out):
        with self.data_lock:
            for red in self.names_lens:
                np.copyto(global_out[red], self.global_data[red])

    def peek_tail(self, redname, k):
        """Copy of the last ``k`` entries of a reduction's global — the
        cheap poll for callers whose freshness gate lives in a vector
        tail (per-shard timestamps), sparing the full-vector memcpy
        under the data lock at spin frequency."""
        with self.data_lock:
            return self.global_data[redname][-k:].copy()

    # side-gig accessors — called WITH the lock already held by the
    # listener (ref. listener_util.py:229-274 "_unsafe_*")
    def _unsafe_get_global_data(self, redname, global_out):
        np.copyto(global_out[redname], self.global_data[redname])

    def _unsafe_put_local_data(self, redname, local_in):
        np.copyto(self.local_data[redname], local_in[redname])

    # ---- synchronous barrier-allreduce (the reference's asynch=False
    # path, listener_util.py:193-199) over a DEDICATED window row (ids
    # stay aligned because only these collective calls write it — every
    # participant must call it the same number of times, the usual
    # collective-op contract) ----
    def sync_allreduce(self, vec, timeout=300.0, abort_on_quit=True):
        """Blocking sum over all participants of ``vec``: publish on this
        round's parity row, wait until every peer's write-id there
        reaches this round's, sum. ``abort_on_quit=False`` is for
        collectives where a peer's (graceful) quit is expected — e.g. a
        final wrap-up reduce after the group has quit the async loop."""
        red = _SYNC[self._sync_round % 2]
        expect = self._sync_round // 2 + 1
        self._sync_round += 1
        vec = np.asarray(vec, dtype=np.float64)
        row_len = self._windows[red][self.me].length
        assert vec.size <= row_len, "sync_allreduce vector too long"
        pad = np.zeros(row_len)
        pad[:vec.size] = vec
        self._windows[red][self.me].put(pad)
        deadline = time.monotonic() + timeout
        total = np.zeros_like(pad)
        while True:
            ready = True
            total[:] = 0.0
            for p in range(self.n):
                vals, wid = self._windows[red][p].read()
                if wid < expect:
                    ready = False
                    break
                total += vals
            if ready:
                return total[:vec.size]
            if abort_on_quit and self.global_quitting:
                # a peer failed/quit mid-collective: surface that instead
                # of masking it behind a 300 s TimeoutError
                raise RuntimeError(
                    "sync_allreduce: group quit while waiting for peers")
            if time.monotonic() > deadline:
                raise TimeoutError("sync_allreduce: peers never caught up")
            time.sleep(0.005)

    # ---- the listener ----
    def _beat(self):
        with self.data_lock:
            for red in self.names_lens:
                self._windows[red][self.me].put(self.local_data[red])
            for red in self.names_lens:
                acc = self.global_data[red]
                acc[:] = 0.0
                for p in range(self.n):
                    vals, _ = self._windows[red][p].read()
                    acc += vals
                gig = self.listener_gigs.get(red)
                if self.enable_side_gig and gig is not None:
                    fct, kwargs = gig
                    fct(self, **(kwargs or {}))
            # control: [quitting, sleep] — sum of quits, min of sleeps
            self._windows[_CTRL][self.me].put(
                np.array([float(self.quitting), self.sleep_secs]))
            quit_sum, sleep_min = 0.0, self.sleep_secs
            for p in range(self.n):
                vals, wid = self._windows[_CTRL][p].read()
                if wid > 0:             # peer has published at least once
                    quit_sum += vals[0]
                    sleep_min = min(sleep_min, vals[1]) if vals[1] > 0 \
                        else sleep_min
            self.global_quitting = int(quit_sum > 0)
            self._beats += 1
        return sleep_min

    def _listener_loop(self):
        # any beat failure (a raising side gig, a torn window) must not
        # kill the daemon SILENTLY: freeze-without-quit stalls every
        # peer until their wait timeouts. Publish quit on the way out,
        # and keep the exception so run() can re-raise it — a crashed
        # listener must not demote the run to a quiet partial result.
        try:
            while self.global_quitting == 0:
                sleep_for = self._beat()
                time.sleep(sleep_for)
        except BaseException as e:
            self._listener_error = e
            raise
        finally:
            self.quitting = 1
            try:
                self._beat()            # final beat publishes my quit flag
            except Exception:
                pass

    def run(self, work_fct, args=(), kwargs=None):
        """Start the listener daemon, run the worker inline, then quit the
        group (any participant finishing stops every listener — the
        reference's summed quitting reduce, listener_util.py:306)."""
        self._listener_error = None
        self._listener = threading.Thread(target=self._listener_loop,
                                          name="sp-listener", daemon=True)
        self._listener.start()
        try:
            result = work_fct(*args, **(kwargs or {}))
        finally:
            self.quitting = 1
            self._listener.join(timeout=30.0)
        if self._listener_error is not None:
            raise RuntimeError("listener thread failed mid-run; the "
                               "worker's result is built on stale "
                               "reductions") from self._listener_error
        return result

    @property
    def beats(self):
        """Completed listener beats (observability: a worker solving for
        seconds should see this advance — the wall-clock overlap)."""
        return self._beats


def cleanup_shm(prefix: str):
    """Best-effort unlink of every shm segment a participant group with
    this prefix may have left behind (crashed/terminated children never
    reach Synchronizer.close()). POSIX shm names surface under /dev/shm
    on Linux; missing files are fine."""
    import glob
    import os

    for f in glob.glob(f"/dev/shm{prefix}.*"):
        try:
            os.unlink(f)
        except OSError:
            pass
