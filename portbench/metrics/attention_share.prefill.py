"""attention_share.prefill (%): of the device seconds of the window's prefill
steps, the share spent in operations the port captured under its
``model.attention`` span (GQA repeat, scores, scale, mask, softmax, cast,
P.V), read by laying each step's traced operations over its graph's capture
map (harness/spans.py). None where under 95% of those seconds were laid.
Layer: model step. Device trace and the program's spans."""
from portbench.harness.spans import share_under


def read(run):
    return share_under(run, "prefill", "model.attention")
