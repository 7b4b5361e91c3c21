"""JAX reference outputs computed once per pytest run and shared by its
xdist workers.

The port's tests hold each torch function to its JAX original on the same
inputs.  Under ``pytest -n N`` a module-scoped fixture runs in every worker
that draws one of the module's tests, and several modules hold the port
to the same JAX program on the same inputs, so the same JAX reference
would otherwise be compiled and run several times in one run.
``shared(tmp_path_factory, name, fn, *args)`` runs ``fn(*args)`` in the
first worker that asks for it, stores the result (bytes, numpy arrays,
tuples, lists and dicts of them: anything pickle takes) in the run's own
temporary directory and hands the stored value to every later caller;
a worker that asks while another computes it waits on a file lock.

The key is ``name``, ``fn``'s module and qualified name, a hash of the
pickled arguments and every ``OTZ*`` / ``ORZ*`` environment variable (the
knobs the JAX package reads) but those that ``fn.unread_knobs`` lists as
ones it never reads.  A caller that changes a module attribute the
function reads (a monkeypatched cap) names the change in ``name``.  The
directory is ``tmp_path_factory.getbasetemp().parent`` under xdist (the
run's base directory, shared by its workers: pytest-xdist's documented
recipe for data its workers share) and ``getbasetemp()`` itself
otherwise, so nothing outlives the run: every JAX reference is still
computed in each run.

Imports neither jax nor torch at import: the caller's ``fn`` does, and so
do the JAX references below that several modules share.
"""

import fcntl
import hashlib
import os
import pickle

import numpy as np


def _knobs(fn):
    unread = getattr(fn, "unread_knobs", ())
    return sorted((k, v) for k, v in os.environ.items()
                  if k.startswith(("OTZ", "ORZ")) and k not in unread)


def _root(tmp_path_factory):
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent
    path = base / "jax_outputs"
    path.mkdir(exist_ok=True)
    return path


def _key_of(name, fn, args) -> str:
    blob = pickle.dumps((name, fn.__module__, fn.__qualname__, args,
                         _knobs(fn)), protocol=4)
    return hashlib.sha256(blob).hexdigest()[:24]


def shared(tmp_path_factory, name, fn, *args):
    """fn(*args), computed once per run across the xdist workers."""
    path = _root(tmp_path_factory) / f"{name}-{_key_of(name, fn, args)}.pkl"
    with open(f"{path}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if path.exists():
                return pickle.loads(path.read_bytes())
            blob = pickle.dumps(fn(*args), protocol=4)
            tmp = path.with_suffix(f".tmp{os.getpid()}")
            tmp.write_bytes(blob)
            os.replace(tmp, path)
            return pickle.loads(blob)  # every caller gets the stored value
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


# --- JAX references that several test modules hold the port to -------------


def jax_front(segs, cap: int, depth: int):
    """``orz_tpu.device.batch.b_front_jit`` on ``segs`` padded to ``cap``,
    as host arrays: (starts, n_items, pk1, bestq, bestro, bufs, mask).
    ``tests/test_torch_slice.py`` and ``tests/test_torch_l2.py`` run it on
    the same segments, at level 2's depth."""
    import jax.numpy as jnp

    from orz_tpu.device.batch import b_front_jit
    from orz_tpu_torch.device.host import pad_batch

    bufs, lens = (jnp.asarray(a) for a in pad_batch(segs, cap))
    return tuple(np.asarray(a) for a in b_front_jit(bufs, lens, depth))


# FRONT (the unmasked analysis, the parse, the walk) is the same at every
# OTZ2 schedule: tests/test_torch_l2.py sets one, tests/test_torch_slice.py
# does not
jax_front.unread_knobs = ("OTZ2", "OTZ2_SCHEDULE", "OTZ2_ITERS",
                          "OTZ2_SHIFTS")
