from . import dynamics
from .ttc import ttc_tables, check_ttc
