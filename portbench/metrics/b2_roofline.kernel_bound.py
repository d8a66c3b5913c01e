"""`b2_roofline` in the cells whose end-to-end metric is
`audio_rtf.kernel_bound`: read as there."""

from portbench import harness

read = harness.metric_reader("b2_roofline")
