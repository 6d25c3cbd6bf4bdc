"""The class API: ``DeseqDataSet`` and ``DeseqStats``."""
