from omniparser_tpu_torch.serving.http import main

if __name__ == "__main__":
    main()
