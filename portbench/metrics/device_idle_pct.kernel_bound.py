"""`device_idle_pct.synth` in the cells whose end-to-end metric is
`audio_rtf.kernel_bound`: read as there."""

from portbench import harness

read = harness.metric_reader("device_idle_pct.synth")
