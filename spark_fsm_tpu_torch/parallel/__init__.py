"""See the matching subpackage of ``spark_fsm_tpu``."""
