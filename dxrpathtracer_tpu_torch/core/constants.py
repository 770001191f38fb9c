"""Shared numeric conventions.

Parity with reference Constants.hlsl (SampleFramework12/v1.02/Shaders/Constants.hlsl:13-27):
the renderer stores physical light units pre-scaled by FP16Scale = 2^-10 so radiance
fits comfortably in half floats, and clamps per-sample radiance to FP16Max.
"""

Pi = 3.141592654
Pi2 = 6.283185307
Pi_2 = 1.570796327
Pi_4 = 0.7853981635
InvPi = 0.318309886
InvPi2 = 0.159154943

FP32Max = 3.402823466e+38
FP32Epsilon = 1.192092896e-07

# Max value storable in an fp16 buffer (a little less than 65504 for headroom).
FP16Max = 65000.0

# Scale factor used for storing physical light units in fp16 floats (2^-10).
FP16Scale = 0.0009765625
