"""The film's return to the host, milliseconds a frame: the median over
the window's untraced frames of the program's span `render.film_copy`
(the film's copy to the host and its division by the samples), recorded
with the program's span recorder on, which synchronises the device's
queued work in a span of its own before it."""

from benchmark import spans


def read(ctx, data):
    return spans.median_ms(ctx['spans'], set(ctx['untraced_frames']),
                           data['span'])
