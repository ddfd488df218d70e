// A width library's bounce entries (packet_width.cuh): the default instances
// at DE_WIDTH wavelengths, the gases' sun transmittance in closed form. They
// compile every scene, march, estimator and floor option in at its default,
// as the main library's default instances do, so a launch at the default
// TraceConfig spends no registers on options it does not read; any other
// setting takes the floor instances of bounce_floor.cu. Built only with
// -DDE_WIDTH=L (kernels.width_library), never into the main library.
#include "../bounce.cuh"

namespace de {

DE_BOUNCE_INSTANCE(DE_WIDTH, false, INST_DEFAULT);
template int entry_occupancy<INST_DEFAULT, DE_WIDTH>(int, int*);

}  // namespace de
