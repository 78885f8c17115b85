"""host_wait_pct.offline (%, program span): the engine's ``wait.*`` spans
(the state reset's blocking copy and the synchronize that end the
prefill, the waits for the decode loop's done flags, the loop's final
reads) over the traced slice, the window's second batch whole: the share
in which the host waits on the card. Where the card idles and the host
is not waiting, the host holds the card back. Higher is better for a
change on the host; a change that shortens the card's work lowers it
too, so it is read beside ``device_idle_pct.offline``."""

from harness.spans import share_pct


def read(rec):
    return share_pct(rec, lambda name: name.startswith("wait."))
