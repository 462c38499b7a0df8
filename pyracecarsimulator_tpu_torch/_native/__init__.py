"""The native host tier: ``loader`` builds ``csrc/racecar_native.cpp`` at
first use and serves map compile and the CPU oracle through ctypes."""
