// The bounce entries' instances for a packet of one wavelength
// (TraceConfig.hero_lambdas = 1, the reference's single-wavelength
// estimator), the gases' sun transmittance in closed form. A source of its
// own, so that nvcc builds it in parallel with the other instances
// (bounce.cuh, bounce.cu).
#include "bounce.cuh"

namespace de {

DE_BOUNCE_INSTANCE(1, false, INST_DEFAULT);

}  // namespace de
