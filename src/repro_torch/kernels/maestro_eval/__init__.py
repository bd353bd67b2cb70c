from .maestro_eval import FEATURES, closed_form_features, maestro_eval
from .ops import dse_eval
from .ref import maestro_eval_ref
from .tables import EvalTables, build_tables
