"""Constants of the reference's estimator, frozen with the plain form it
serves (reference/path_vertex.py)."""

INF = float('inf')
PI = 3.141592653589793

MAT_LAMBERTIAN = 0
MAT_ROUGH_PLASTIC = 1
FILTER_BOX = 0

# Path length cap of the estimator (Russian roulette ends paths far
# earlier).
MAX_BOUNCES_CAP = 64

# Epsilons proportional to the scene's bounding-sphere radius, capped.
EPS_SCALE = 1e-4
EPS_CAP = 0.01

# Default options of an <integrator type="path"/> element with no
# children, as the benchmark's scene files write it.
MAX_DEPTH = -1
RR_DEPTH = 5
