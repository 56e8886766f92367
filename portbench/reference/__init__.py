"""The plain reference (float32 PyTorch) that decides `correct`."""
