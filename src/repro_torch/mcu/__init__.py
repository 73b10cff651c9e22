from .compile import (CompiledExecutor, LoweringCtx, compile_schedule,
                      lower_op, register_lowering)

__all__ = ["CompiledExecutor", "LoweringCtx", "compile_schedule",
           "lower_op", "register_lowering"]
