// A width library's bounce entries (packet_width.cuh): the default instances
// at DE_WIDTH wavelengths, the gases' sun transmittance by ratio tracking. A
// source of its own, so that nvcc builds it in parallel with the other
// instances. Built only with -DDE_WIDTH=L (kernels.width_library).
#include "../bounce.cuh"

namespace de {

DE_BOUNCE_INSTANCE(DE_WIDTH, true, INST_DEFAULT);

}  // namespace de
