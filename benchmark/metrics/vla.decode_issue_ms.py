"""The host's own time to issue ``greedy_generate_llava``'s decode
steps, in ms a generate call: ``StageTimer`` ``vla_decode`` (the
decode-step loop on the host clock, ending before the closing
synchronization) less the prefill's device work still queued when the
loop starts, estimated as the mean ``prefill_ms`` (CUDA events) less
``vla_prefill``, the host's time to issue the prefill. The loop blocks
on a full launch queue while that work runs, so without the subtraction
a faster prefill would lower this metric too. The estimate leaves in any
of the image encoding still queued behind the prefill. Set beside
``vla.decode_ms``, the same steps on the device's timeline: where this
is as long or longer, the decode waits on its launches."""


def read(run):
    dec, pre = run.stages.get("vla_decode"), run.stages.get("vla_prefill")
    if run.kind != "serve" or not dec or not dec["count"] or not pre \
            or not pre["count"]:
        return None
    prefill = [v["prefill_ms"] for v in run.vla if "prefill_ms" in v]
    if not prefill:
        return None
    queued = sum(prefill) / pre["count"] - 1e3 * pre["total_s"] / pre["count"]
    return 1e3 * dec["total_s"] / dec["count"] - max(queued, 0.0)
