"""expert_share.dsv2: the router's and the held experts' share of a DeepSeek-V2-Lite step's card time, in %.

As ``attention_share.dsv2``, over the ``tnc:moe.route`` ranges (the f32
router, its top-k and balance loss) and the ``tnc:moe.experts`` ranges (the
held experts' grouped products and the combine).
"""

from probebench.ranges import step_share


def read(run):
    return step_share(run, ("moe.route", "moe.experts"))
