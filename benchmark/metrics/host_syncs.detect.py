"""host_syncs.detect: the program's host_syncs counter over a call's root
spans: blocking device-to-host reads, from the program's own spans
(lib/spans.py)."""

from benchmark.lib import spans


def read(run):
    return spans.counted(run, "host_syncs")
