// The bounce entries' estimator instances (the options instances' scene and
// march options and naive arm, and TraceConfig's estimator options read at run
// time, bounce.cuh) for a packet of four wavelengths, the gases' sun
// transmittance in closed form (the default's width and transmittance). A
// source of its own, so that nvcc builds it in parallel with the other
// instances (bounce.cuh, bounce.cu).
#include "bounce.cuh"

namespace de {

DE_BOUNCE_INSTANCE(4, false, INST_ESTIMATOR);
template int entry_occupancy<INST_ESTIMATOR>(int, int*);

}  // namespace de
