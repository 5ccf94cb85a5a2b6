"""Sentinel constants and epsilons shared across the framework.

These replicate the reference renderer's numeric conventions exactly
(reference: limits.h:3-8, kernel.cu:28-35, modelLoader.h:64):

* ``MAX_FLOAT`` is the ray-miss sentinel. The reference deliberately uses
  100000.0 rather than FLT_MAX (limits.h:3) and tests for a miss with
  ``t > MAX_FLOAT - 1`` (kernel.cu:279, 436).
* ``PI_REF`` is the truncated pi the reference hard-codes everywhere
  (kernel.cu:66, 84, 103, 369, ...). Using math.pi instead would shift the
  radiometry by ~8e-7 relative — we keep the reference constant so renders
  are comparable.
* ``EPS_PARALLEL`` is the Moller-Trumbore near-parallel rejection threshold
  (modelLoader.h:64).
* ``EPS_HIT`` is the 0.001 shadow/offset epsilon used throughout the
  integrators (kernel.cu:261, 278, 311, 334, 431).
* ``EPS_VISIBILITY`` is the BDPT shadow-ray distance tolerance
  (kernel.cu:403).
* ``THROUGHPUT_CUTOFF`` gates BDPT shadow rays; contributions below it are
  zeroed entirely, a reference quirk we replicate (kernel.cu:394-398).
"""

MAX_FLOAT = 100000.0
PI_REF = 3.14159
EPS_PARALLEL = 1e-5
EPS_HIT = 0.001
EPS_VISIBILITY = 0.01
THROUGHPUT_CUTOFF = 0.01

# Flat-BVH encoding flags (reference: limits.h:5-8). Our threaded encoding
# does not need a leaf bit on child indices (leaves are explicit nodes), but
# the native builder's intermediate array format keeps the convention.
BVH_LEAF_FLAG = 0x80000000
MAX_BVH_INDEX = 0x7FFFFFFF
MAX_BVH_DEPTH = 64
