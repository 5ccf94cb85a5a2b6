"""The share of the packet engine's lanes that carry a live ray, from the
program's own counter: 100 x the sum of ``packets.live_rays`` (the
masked-in rays of a call's last round) over the sum of ``rays`` (the
call's R), over every ``packets.trace`` span of the traced run that
counted its live rays."""

from h100_bench import program_spans as ps

ps.switch_on()


def live_rays_pct(recs):
    calls = [x.attrs for x in ps.spans(recs, "packets.trace")
             if "packets.live_rays" in x.attrs]
    rays = sum(a["rays"] for a in calls)
    if not rays:
        return None
    return 100.0 * sum(a["packets.live_rays"] for a in calls) / rays


def read(r):
    recs = ps.records(r)
    return None if recs is None else live_rays_pct(recs)
