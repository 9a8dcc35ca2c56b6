"""The frozen plain reference the benchmark judges the port by.

Plain PyTorch and numpy over state dicts, in float32 (the optics in
float64), with TF32 off.  It imports nothing of the program: every
constant the program's set-up derives (camera and lens phases, packed or
folded weights) is worked out again here from the configuration.
"""
