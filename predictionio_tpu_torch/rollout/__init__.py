"""Release health gating: the port has the gate's policy only
(:mod:`.policy`), which the stream trainer's canary uses."""
