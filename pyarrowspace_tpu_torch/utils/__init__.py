from .debug import (dbg_println, debug_enabled, get_phase_timings, phase,
                    reset_phase_timings, set_debug)
