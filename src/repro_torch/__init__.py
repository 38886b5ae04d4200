"""PyTorch/CUDA port of GreenCache.

A second package beside the JAX reference ``repro``. It imports torch,
numpy and the standard library only — never ``jax`` and nothing of
``repro``; what it needs from the reference's JAX-free modules it keeps as
its own copies under the same names. It has two parts:

* The real-execution path: the same model configs and models, the real
  serving engine and training, with the attention and recurrent kernels
  written by hand in CUDA C++ for Hopper (``sm_90a``). Its entry points run
  on ``cuda`` unless the caller passes ``device="cpu"``.
* The simulator's profile-and-solve path, the paper's contribution: the
  carbon model (``core.carbon``), the cache stores and their policies
  (``core.kvstore``, ``core.policies``, ``core.radix``, ``core.storage``),
  resource plans (``core.plan``), the simulated serving cluster
  (``serving.{perfmodel,engine,cluster}``), the workloads, the ledger and
  trace recorder (``obs``), the §5.2 profiler (``core.profiler``) and the
  §5.4 solver (``core.solver``).

The simulator stays NumPy host code and imports no torch. The reference's
contracts there are NumPy float64 contracts, bit for bit: the vectorised
DP equals the loop DP, the store's column index (a stable lexsort) equals
the stable ``sorted`` of the scalar path, the decode fixed point is the
same in the engine and in the solver, and every request stream comes from
a ``np.random.default_rng`` seed. Its arrays are small (at most a few
hundred rate buckets times tens of options, or a few 10^4 requests), so a
launch on a card would cost more than the work, and torch reductions would
change the order of the sums. It takes no device argument: nothing in it
runs on a card.
"""
