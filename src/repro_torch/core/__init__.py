"""MAFIA core: DFG IR, compile pipeline, quantizer, plan interpreter."""
