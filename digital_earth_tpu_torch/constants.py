"""Physical constants of the Earth/atmosphere scene (a copy of
digital_earth_tpu/constants.py, so the port imports nothing of the JAX
package; tests/test_torch_elementwise.py holds the two equal)."""

import numpy as np

# --- Atmosphere gas constants (reference volume_rendering_models.py:9-19) ---
AIR_NUM_DENSITY = 2.5035422e25
OZONE_PEAK = 8e-6
OZONE_NUM_DENSITY = AIR_NUM_DENSITY * 0.012588 * OZONE_PEAK
OZONE_PEAK_HEIGHT = 25000.0  # peak ozone density at 25 km

MIE_G = 0.75
MIE_ASYMMETRY = 3000.0  # Klein-Nishina "e" parameter
TURBIDITY = 1.06

# --- Interaction ids (reference volume_rendering_models.py:21-25) ---
RAYLEIGH_ID = 0
MIE_ID = 1
OZONE_ID = 2
CLOUD_ID = 3
ISOTROPIC_CLOUD_ID = 4

# --- Single-scattering albedos (reference volume_rendering_models.py:27-30) ---
RAYLEIGH_ALBEDO = 1.0
AEROSOL_ALBEDO = 0.95
OZONE_ALBEDO = 0.0
CLOUD_ALBEDO = 0.99
SCATTERING_ALBEDOS = np.array(
    [RAYLEIGH_ALBEDO, AEROSOL_ALBEDO, OZONE_ALBEDO, CLOUD_ALBEDO], dtype=np.float32
)

# --- Planet geometry (reference volume_rendering_models.py:34-36) ---
PLANET_R = 6371e3
ATMOS_HEIGHT = 110e3
ATMOS_UPPER_LIMIT = PLANET_R + ATMOS_HEIGHT

# --- Cloud slab (reference volume_rendering_models.py:38-44) ---
CLOUDS_EXTINCT = 0.1
CLOUDS_DENSITY = 0.029
CLOUDS_HEIGHT = 4000.0
CLOUDS_THICKNESS = 6000.0
CLOUDS_LOWER_LIMIT = PLANET_R + CLOUDS_HEIGHT
CLOUDS_UPPER_LIMIT = CLOUDS_LOWER_LIMIT + CLOUDS_THICKNESS

# Cloud droplet size (um) used by the HG+Draine phase mix
# (reference volume_rendering_models.py:156,167)
CLOUD_DROPLET_SIZE = 8.0

# --- Path-tracer budgets (reference pathtracer.py:349,448,37) ---
MAX_BOUNCES = 25
RUSSIAN_ROULETTE_START = 3  # RR applies for scatter_count > 3
LAND_MARCH_STEPS = 250
MULTISCATTER_BOUNCE = 9  # after this many bounces clouds go isotropic/low-extinction
MULTISCATTER_CLOUD_EXTINCT = 0.02

# --- Sun (reference renderer.py:297-300) ---
SUN_RADIUS = 6.95e8
SUN_DISTANCE = 1.4959e11
SUN_ANGULAR_RADIUS = SUN_RADIUS / SUN_DISTANCE
SUN_COS_ANGLE = float(np.cos(SUN_ANGULAR_RADIUS))
SUN_TEMPERATURE = 5778.0  # K (reference pathtracer.py:332)
NIGHTLIGHT_TEMPERATURE = 2700.0  # K (reference pathtracer.py:333)
NIGHTLIGHT_SCALE = 1e-4
STARS_SCALE = 1e-7  # reference pathtracer.py:463

# --- Renderer defaults (reference renderer.py:49-58) ---
DEFAULT_FOV = float(np.radians(27.0) * 0.5)
DEFAULT_EXPOSURE = 2.5
DEFAULT_GAMMA = 1.0
DEFAULT_SUN_ANGLE = float(np.radians(60.0))
DEFAULT_SUN_PATH_ROT = float(np.radians(-45.0))
DEFAULT_LAND_HEIGHT_SCALE = 7800.0
