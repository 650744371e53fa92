"""Fault-tolerant elastic training: preemption handling and supervised
relaunch (the port of ``repro/launch/resilience.py``, DESIGN.md §12).

The 256-GPU regime the paper trains in is where node loss and preemption
are routine; a long campaign survives them with three layers:

* :class:`PreemptionHandler` -- catches SIGTERM/SIGUSR1 (the signals
  cluster schedulers send before reclaiming a node), lets the in-flight
  step finish, and tells the engine to take a final SYNCHRONOUS save and
  raise :class:`Preempted`.  ``launch/train.py`` turns that into
  :data:`RESUMABLE_EXIT_CODE`, so a supervisor can tell "preempted,
  checkpoint durable, relaunch me" from a crash.

* :class:`Supervisor` -- the relaunch loop behind ``--supervise
  --max-restarts N``: runs the training command, discovers the latest
  COMPLETE checkpoint (``checkpoint.latest_checkpoint`` validates the
  manifest and the shard files, so a torn save is never resumed from)
  before every launch, restarts at once on a resumable exit and with
  jittered exponential backoff on a crash.

* elastic resharding lives in ``TrainEngine._restore``: the checkpoint may
  come from another mesh; each rank reads its blocks of the current
  mesh's parameter and ZeRO-1 layouts, so an 8-rank job that lost a node
  continues on the survivors.

The port runs one process per rank, where the reference runs one
controller, so two things are its own:

* ranks stop together: after each step the engine follows ``poll`` with
  one MAX all-reduce of the flag over the world (``TrainEngine.
  _agree_stop``), so every rank stops after the same step, takes part in
  the same final save and exits 75, whichever rank was signalled;
* a supervised mesh run launches its world itself (:func:`run_world`: one
  process per rank, each attempt on a fresh rendezvous port), because
  ``torch.distributed.run`` reports a child's exit 75 as its own failure
  (exit 1), which a supervisor around it would take for a crash.

Deterministic chaos hook: ``REPRO_PREEMPT_AT_STEP=N`` (or
``EngineConfig(preempt_at_step=N)``) makes the handler deliver a REAL
``SIGTERM`` to its own process after training step ``N`` completes: the
whole signal path, at a reproducible step.
"""
from __future__ import annotations

import os
import random
import signal
import socket
import subprocess
import sys
import time
import warnings
from functools import partial
from typing import Callable, List, Optional, Sequence, Tuple

from repro_torch import telemetry
from repro_torch.checkpoint.sharded import (checkpoint_complete,  # noqa: F401
                                            latest_checkpoint)

# EX_TEMPFAIL: the sysexits.h "transporter can retry" code -- distinct
# from 0 (done) and from crash codes, so a supervisor knows the exit was
# an orderly preemption with a durable checkpoint behind it.
RESUMABLE_EXIT_CODE = 75

PREEMPT_ENV = "REPRO_PREEMPT_AT_STEP"


class Preempted(Exception):
    """Raised out of ``TrainEngine.run()`` after a preemption signal: the
    in-flight step finished, the final synchronous save (when a checkpoint
    path is configured) is durable, and the process should exit
    :data:`RESUMABLE_EXIT_CODE`."""

    def __init__(self, step: int, checkpoint: Optional[str] = None,
                 signum: Optional[int] = None):
        self.step = step
        self.checkpoint = checkpoint
        self.signum = signum
        super().__init__(
            f"preempted at step {step} (checkpoint={checkpoint!r}, "
            f"signal={signum})")


def _env_int(name: str) -> Optional[int]:
    val = os.environ.get(name)
    return int(val) if val not in (None, "") else None


class PreemptionHandler:
    """Signal-driven stop flag for the training loop.

    ``install()`` replaces the process handlers for ``signals`` (default
    SIGTERM + SIGUSR1) with a flag-setter; the engine calls ``poll(i)``
    after each completed step and, when the run agrees to stop, finishes
    with a final synchronous save instead of dying mid-write.
    ``uninstall()`` restores the previous handlers (the engine does this in
    a finally).

    Handlers can only be installed from the main thread; elsewhere the
    handler stays an inert flag, with a warning (the supervisor still
    restarts on the raw kill, it just loses the final save).
    """

    DEFAULT_SIGNALS = (signal.SIGTERM, signal.SIGUSR1)

    def __init__(self, signals: Sequence[int] = DEFAULT_SIGNALS,
                 preempt_at_step: Optional[int] = None):
        self.signals = tuple(signals)
        self.received: Optional[int] = None   # signal number once caught
        self.preempt_at_step = (preempt_at_step
                                if preempt_at_step is not None
                                else _env_int(PREEMPT_ENV))
        self._prev: dict = {}
        self.installed = False

    # -- signal plumbing -------------------------------------------------
    def _on_signal(self, signum, frame):
        del frame
        self.received = signum

    def install(self) -> "PreemptionHandler":
        try:
            for s in self.signals:
                self._prev[s] = signal.signal(s, self._on_signal)
            self.installed = True
        except ValueError:
            # not the main thread: restore whatever was set
            self.uninstall()
            warnings.warn(
                "PreemptionHandler: signal handlers can only be installed "
                "from the main thread; signal-driven final saves disabled "
                "for this run")
        return self

    def uninstall(self) -> None:
        for s, prev in self._prev.items():
            signal.signal(s, prev)
        self._prev = {}
        self.installed = False

    def __enter__(self) -> "PreemptionHandler":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()

    # -- loop interface --------------------------------------------------
    @property
    def should_stop(self) -> bool:
        return self.received is not None

    def poll(self, step: int) -> bool:
        """True once a preemption signal has arrived.  With the chaos hook
        armed (``preempt_at_step``), completing that step first delivers a
        real SIGTERM to this process -- the production signal path, at a
        deterministic step."""
        if (self.installed and not self.should_stop
                and self.preempt_at_step is not None
                and step == self.preempt_at_step):
            # emitted here, NOT in _on_signal: the tracer lock is not
            # async-signal-safe
            telemetry.get_tracer().event("preempt.chaos_sigterm",
                                         step=step)
            os.kill(os.getpid(), signal.SIGTERM)
        return self.should_stop


class Supervisor:
    """Relaunch loop: run a training command until it exits clean,
    resuming from the latest complete checkpoint on every launch.

    Parameters
    ----------
    build_cmd : (resume_path, attempt) -> argv list.  ``resume_path`` is
        the newest COMPLETE checkpoint under ``ckpt_root`` (None on a cold
        start), rediscovered before EVERY launch, so a relaunch always
        continues from the most recent durable save -- including one
        written under an earlier supervisor.
    ckpt_root : directory scanned by ``latest_checkpoint``; ``prefix``
        restricts discovery to ``<prefix>`` / ``<prefix>-*`` entries (the
        engine's ``--ckpt out/ck`` layout -> root="out", prefix="ck").
    max_restarts : relaunch budget.  Resumable exits restart at once (the
        work is checkpointed; waiting buys nothing); crash exits back off
        exponentially with jitter, up to ``max_backoff``.
    run_cmd / sleep_fn : injectable (tests; :func:`run_world` on a mesh).
    """

    def __init__(self, build_cmd: Callable[[Optional[str], int], List[str]],
                 *, ckpt_root: Optional[str] = None,
                 prefix: Optional[str] = None, max_restarts: int = 3,
                 backoff: float = 1.0, max_backoff: float = 60.0,
                 resumable_codes: Tuple[int, ...] = (RESUMABLE_EXIT_CODE,),
                 env: Optional[dict] = None,
                 run_cmd: Optional[Callable[[List[str]], int]] = None,
                 sleep_fn: Callable[[float], None] = time.sleep):
        self.build_cmd = build_cmd
        self.ckpt_root = ckpt_root
        self.prefix = prefix
        self.max_restarts = max_restarts
        self.backoff = backoff
        self.max_backoff = max_backoff
        self.resumable_codes = tuple(resumable_codes)
        self.env = env
        self._run_cmd = run_cmd or (
            lambda argv: subprocess.call(argv, env=self.env))
        self.sleep_fn = sleep_fn
        self.attempts: List[int] = []      # exit code per launch
        self.resumes: List[Optional[str]] = []  # resume path per launch
        self.backoffs: List[float] = []    # sleeps taken (crash restarts)

    def _discover(self) -> Optional[str]:
        if not self.ckpt_root:
            return None
        return latest_checkpoint(self.ckpt_root, prefix=self.prefix)

    def run(self) -> int:
        tr = telemetry.get_tracer()
        restarts = 0
        delay = self.backoff
        while True:
            resume = self._discover()
            argv = self.build_cmd(resume, len(self.attempts))
            self.resumes.append(resume)
            tr.event("supervisor.launch", attempt=len(self.attempts),
                     resume=resume)
            with tr.span("supervisor.attempt",
                         attempt=len(self.attempts)):
                rc = self._run_cmd(argv)
            self.attempts.append(rc)
            tr.event("supervisor.exit", attempt=len(self.attempts) - 1,
                     code=rc)
            if rc == 0:
                return 0
            if restarts >= self.max_restarts:
                print(f"[supervisor] exit {rc} with no restart budget "
                      f"left ({self.max_restarts}); giving up")
                tr.event("supervisor.give_up", code=rc,
                         restarts=restarts)
                return rc
            restarts += 1
            tr.counter("supervisor.restarts")
            if rc in self.resumable_codes:
                print(f"[supervisor] resumable exit ({rc}); relaunching "
                      f"immediately (restart {restarts}/{self.max_restarts})")
                tr.counter("supervisor.resumable_restarts")
                continue
            sleep = delay * (1.0 + 0.25 * random.random())
            print(f"[supervisor] crash exit ({rc}); backing off "
                  f"{sleep:.1f}s then relaunching "
                  f"(restart {restarts}/{self.max_restarts})")
            tr.event("supervisor.backoff", seconds=sleep, code=rc)
            self.backoffs.append(sleep)
            self.sleep_fn(sleep)
            delay = min(delay * 2.0, self.max_backoff)


def strip_args(argv: Sequence[str], flags: Sequence[str],
               valued: Sequence[str] = ()) -> List[str]:
    """Drop bare ``flags`` and ``valued`` options (both ``--x v`` and
    ``--x=v`` forms) from an argv copy -- used to rebuild the child
    command from the supervisor's own argv."""
    out: List[str] = []
    skip = False
    for a in argv:
        if skip:
            skip = False
            continue
        if a in flags:
            continue
        if a in valued:
            skip = True
            continue
        if any(a.startswith(v + "=") for v in valued):
            continue
        out.append(a)
    return out


def free_port() -> int:
    """A TCP port on the loopback interface that is free now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def world_exit_code(codes: Sequence[int]) -> int:
    """One code for a world's ranks: 0 if every rank finished, 75 if every
    rank exited resumable, else the first code that is neither (1 when
    the ranks only disagree between 0 and 75)."""
    if all(c == 0 for c in codes):
        return 0
    if all(c == RESUMABLE_EXIT_CODE for c in codes):
        return RESUMABLE_EXIT_CODE
    return next((c for c in codes if c not in (0, RESUMABLE_EXIT_CODE)), 1)


def run_world(argv: List[str], world: int, *, env: Optional[dict] = None,
              grace: float = 5.0, poll: float = 0.1) -> int:
    """Run ``world`` copies of ``argv`` on this host as the ranks of one
    process group (``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE``,
    ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR=127.0.0.1`` and a fresh
    ``MASTER_PORT``, the ``env://`` rendezvous ``launch/mesh.py`` joins);
    returns :func:`world_exit_code` of the ranks' codes.  Once a rank
    exits with a code other than 0 or 75, the others are terminated (and
    killed after ``grace`` seconds: they may be blocked in a collective
    with the dead rank), and its code is the world's."""
    base = dict(os.environ if env is None else env)
    port = free_port()
    procs = [subprocess.Popen(argv, env=dict(
        base, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(world),
        LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
        MASTER_PORT=str(port))) for r in range(world)]
    failed = None
    try:
        while True:
            codes = [p.poll() for p in procs]
            failed = next((c for c in codes
                           if c not in (None, 0, RESUMABLE_EXIT_CODE)), None)
            if failed is not None or None not in codes:
                break
            time.sleep(poll)
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            try:
                p.wait(timeout=grace)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
    return failed if failed is not None else world_exit_code(
        [p.returncode for p in procs])


def supervise_train_cli(args, argv: Sequence[str]) -> int:
    """The ``--supervise`` mode of ``launch/train.py``: relaunch this same
    command (without the supervisor's flags, with ``--resume <latest>``)
    until it exits clean or the restart budget runs out.  On a mesh
    (``--mesh-model`` x ``--mesh-data`` > 1) each launch is a whole world
    (:func:`run_world`)."""
    root = os.path.dirname(os.path.abspath(args.ckpt)) or "."
    prefix = os.path.basename(args.ckpt)
    base = strip_args(argv, flags=("--supervise",),
                      valued=("--max-restarts", "--resume"))

    def build(resume: Optional[str], attempt: int) -> List[str]:
        del attempt
        cmd = [sys.executable, "-m", "repro_torch.launch.train"] + list(base)
        if resume:
            cmd += ["--resume", resume]
        return cmd

    world = args.mesh_model * args.mesh_data
    sup = Supervisor(build, ckpt_root=root, prefix=prefix,
                     max_restarts=args.max_restarts,
                     run_cmd=partial(run_world, world=world)
                     if world > 1 else None)
    return sup.run()
