"""The plain reference: plain PyTorch and NumPy, float32 with TF32 off. It
imports nothing of the program."""
