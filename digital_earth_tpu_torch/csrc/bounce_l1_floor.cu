// The bounce entries' floor instances (the estimator instances' options and
// TraceConfig's march floors read at run time, bounce.cuh) for a packet of
// one wavelength, the gases' sun transmittance in closed form. A source of
// its own, so that nvcc builds it in parallel with the other instances
// (bounce.cuh, bounce.cu).
#include "bounce.cuh"

namespace de {

DE_BOUNCE_INSTANCE(1, false, INST_FLOORS);

}  // namespace de
