// Kernel 3 (csrc/ipm.cu, the whole-batch IPM) at the shapes built without
// contracted multiply-adds: ops/_build.py compiles this source with
// -fmad=false, so each product is rounded before it is added, as in the
// plain version.  On the car QP's real cones (the rotated-cone epigraph of
// the squared cost, whose f32 iterates stall near a score of 5e-5) the
// contracted build's median distance from an f64 solve was 1.30-2.05
// times the plain f32 version's on five sets of 256 problems, this build's
// 1.21-1.29 times (probe_ipm.py --contraction, NVIDIA H100 80GB HBM3 at
// 700 W; chip_smoke.py's kernel check holds it to 2).  The other shapes
// keep csrc/ipm.cu's build and its bits.
//  (3, 5, 4)  group width 8: the car's ground-truth CBC QP, [u (2), t] with
//             cones of dimensions (4, 1, 1, 1, 1) (objective, four
//             obstacles).
#define IPM_SHAPES Shape<3, 5, 4>
#include "ipm.cu"
