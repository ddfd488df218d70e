// A width library's bounce entries (packet_width.cuh): the floor instances
// at DE_WIDTH wavelengths, the gases' sun transmittance in closed form.
// The floor instances read every scene, march, estimator and floor option
// at run time (bounce.cuh), so this one set serves every TraceConfig at
// this width. Built only with -DDE_WIDTH=L (kernels.width_library), never
// into the main library.
#include "../bounce.cuh"

namespace de {

DE_BOUNCE_INSTANCE(DE_WIDTH, false, INST_FLOORS);
template int entry_occupancy<INST_FLOORS, DE_WIDTH>(int, int*);

}  // namespace de
