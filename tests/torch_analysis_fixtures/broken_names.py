"""An obs.names whose dispatch span reuses the fill's name (OB001)."""
SPAN_LADDER_FILL = "ladder_fill"
SPAN_DISPATCH = "ladder_fill"   # OB001: two metrics would merge

SPAN_NAMES = (SPAN_LADDER_FILL, SPAN_DISPATCH)
EVENT_NAMES = ("xla_compile",)
COUNTER_NAMES = ()
GAUGE_NAMES = ()
HIST_NAMES = ()
