"""Ring all-reduce over a rank transport, f32 and fused int8."""
