"""The benchmark's harness: specs, inputs, the measured loop, the trace
reader, the roofline arithmetic and the comparison that decides
`correct`. Nothing here imports the program except pb/program.py."""
