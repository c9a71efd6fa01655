"""Core of the PyTorch port: the exact bit-serial AP machine model
(`bitplane`, `engine`, `isa`, `arith`, `apfloat`), the paper's analytic
area/performance/power models (`models`), die floorplans (`floorplan`),
the 3D RC thermal solver (`thermal`), the power-trace co-simulation
helpers (`cosim`), and shared thermal constants (`constants`)."""
