// The bounce entries' instances for a packet of one wavelength, the gases'
// sun transmittance by ratio tracking: the reference's own estimator. A
// source of its own, so that nvcc builds it in parallel with the other
// instances (bounce.cuh, bounce.cu).
#include "bounce.cuh"

namespace de {

DE_BOUNCE_INSTANCE(1, true, INST_DEFAULT);

}  // namespace de
