// The bounce entries' instances for a packet of four wavelengths, the
// gases' sun transmittance by ratio tracking (TraceConfig.
// analytic_transmittance = False). A source of its own, so that nvcc builds
// it in parallel with the other instances (bounce.cuh, bounce.cu).
#include "bounce.cuh"

namespace de {

DE_BOUNCE_INSTANCE(4, true, INST_DEFAULT);

}  // namespace de
