// The bounce entries' floor instances (the estimator instances' options and
// TraceConfig's march floors read at run time, bounce.cuh) for a packet of
// four wavelengths, the gases' sun transmittance in closed form (the
// default's width and transmittance). A source of its own, so that nvcc
// builds it in parallel with the other instances (bounce.cuh, bounce.cu).
#include "bounce.cuh"

namespace de {

DE_BOUNCE_INSTANCE(4, false, INST_FLOORS);
template int entry_occupancy<INST_FLOORS>(int, int*);

}  // namespace de
