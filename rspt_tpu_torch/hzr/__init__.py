"""hzr codec: host spec copy (pyref) and the device encoder (torch_coder)."""
